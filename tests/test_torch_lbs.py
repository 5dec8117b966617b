"""Port parity for skinning and the SMPL forward: romp_tpu_torch vs romp_tpu
on the same numpy inputs (CPU: the wrappers take their plain versions)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from romp_tpu.ops.pallas_lbs import skinning_pallas, skinning_xla
from romp_tpu.smpl.assets import synthetic_assets
from romp_tpu.smpl.body_model import SmplModel as JaxSmpl
from romp_tpu.smpl.body_model import smpl_forward as jax_smpl_forward
from romp_tpu_torch.ops.lbs import skinning, skinning_plain
from romp_tpu_torch.smpl.body_model import SmplModel, smpl_forward

torch.set_num_threads(2)


def _skin_inputs(seed=0, B=3, J=24, V=1000):
    # V = 1000 is not a multiple of the Pallas tile: exercises its padding
    rng = np.random.RandomState(seed)
    return (rng.randn(B, 16, J).astype(np.float32),
            np.abs(rng.randn(V, J)).astype(np.float32),
            rng.randn(B, 3, V).astype(np.float32))


@pytest.mark.parametrize("jax_fn", [
    skinning_xla, lambda a, w, v: skinning_pallas(a, w, v, interpret=True)],
    ids=["xla", "pallas_interpret"])
def test_skinning_plain_matches_jax(jax_fn):
    a16, w, vpos = _skin_inputs()
    ours = skinning_plain(*map(torch.from_numpy, (a16, w, vpos))).numpy()
    ref = np.asarray(jax_fn(*map(jnp.asarray, (a16, w, vpos))))
    np.testing.assert_allclose(ours, ref, atol=1e-4)


def test_skinning_wrapper_takes_plain_on_cpu():
    inputs = [torch.from_numpy(a) for a in _skin_inputs(seed=1)]
    before = skinning.launches
    np.testing.assert_array_equal(skinning(*inputs).numpy(),
                                  skinning_plain(*inputs).numpy())
    assert skinning.launches == before      # no kernel launch on the CPU


@pytest.fixture(scope="module")
def smpl_pair():
    assets = synthetic_assets(seed=0)
    return JaxSmpl.from_assets(assets), SmplModel(assets, "cpu")


@pytest.mark.parametrize("root_align", [False, True])
def test_smpl_forward_matches_jax(smpl_pair, root_align):
    jsmpl, tsmpl = smpl_pair
    rng = np.random.RandomState(2)
    betas = rng.randn(4, 10).astype(np.float32)
    pose = (rng.randn(4, 72) * 0.4).astype(np.float32)
    jv, jj = jax.jit(lambda b, p: jax_smpl_forward(
        jsmpl, b, p, root_align=root_align))(betas, pose)
    with torch.inference_mode():
        tv, tj = smpl_forward(tsmpl, torch.from_numpy(betas),
                              torch.from_numpy(pose), root_align=root_align)
    assert tv.shape == (4, 6890, 3) and tj.shape == (4, 71, 3)
    # the bar the JAX package holds against the reference (README.md:43)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)
    np.testing.assert_allclose(tj.numpy(), np.asarray(jj), atol=1e-4)
