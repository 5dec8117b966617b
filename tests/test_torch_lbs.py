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
from romp_tpu_torch.ops.lbs import (
    BWD_PERSONS, BWD_SUB, CHUNK, CTA_RESERVED_SMEM, MAX_SMEM, SM_SMEM,
    WARP_VERTS, skinning, skinning_bwd_plan, skinning_bwd_smem,
    skinning_plain, skinning_plan, skinning_smem, split_tf32_matmul,
    tf32_round,
)
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


# --- the kernel's arithmetic and launch plan (csrc/lbs.cu) ---------------

def test_tf32_round_is_round_to_nearest_ties_away():
    ulp = 2.0 ** -10                      # TF32 keeps 10 mantissa bits
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + 3 * ulp / 2, 1 + ulp / 2 - 2 ** -20,
                      -(1 + ulp / 2), 2.0 ** -130, 0.0], dtype=torch.float32)
    want = [1.0, 1 + ulp, 1 + 2 * ulp, 1.0, -(1 + ulp), 2.0 ** -130, 0.0]
    assert tf32_round(x).tolist() == want
    # every result has its 13 low mantissa bits clear, within half an ulp
    r = torch.from_numpy(np.random.RandomState(0).randn(10000)
                         .astype(np.float32)) * 1e3
    t = tf32_round(r)
    assert int((t.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert float(((t - r).abs() / r.abs()).max()) <= 2.0 ** -11


def _skinning_operands(rows, V, seed=0):
    # the statistics of chip_smoke.py: A16 rows N(0, 1), LBS weights
    # uniform and normalized to sum 1 over the joints
    rng = np.random.RandomState(seed)
    a = torch.from_numpy(rng.randn(rows, 24).astype(np.float32))
    w = rng.rand(V, 24).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    return a, torch.from_numpy(w).t().contiguous()


def test_split_tf32_meets_the_bar_where_one_tf32_product_misses():
    """K = 24 (the skinning's joints): the 3-term split product within 1e-5
    of max|ref| of the f32 product; one TF32 product is not."""
    a, wt = _skinning_operands(1536, 2000)
    ref = (a.double() @ wt.double())
    scale = float(ref.abs().max())
    err3 = float((split_tf32_matmul(a, wt).double() - ref).abs().max())
    err1 = float((split_tf32_matmul(a, wt, terms=1).double() - ref)
                 .abs().max())
    assert err3 <= 1e-5 * scale
    assert err1 > 1e-5 * scale


@pytest.mark.parametrize("N", [1, 8, 64, 1024, 4096])
@pytest.mark.parametrize("V", [6890, 129, 1000])
def test_skinning_plan(N, V):
    """Tiles cover N and V with no empty tile; shared memory within the
    232,448 bytes a CTA may take; the card has at least one CTA per SM
    (132) wherever N and V give that many 32-vertex x 4-person tiles."""
    p = skinning_plan(N, V)
    vt = p.warps * WARP_VERTS
    assert 1 <= p.warps <= 8 and p.persons % CHUNK == 0
    assert p.grid_v * vt >= V > (p.grid_v - 1) * vt
    assert p.grid_n * p.persons >= N > (p.grid_n - 1) * p.persons
    assert p.smem == skinning_smem(p.warps) <= MAX_SMEM
    tiles = -(-V // WARP_VERTS) * -(-N // CHUNK)
    assert p.ctas >= min(132, tiles)


def test_skinning_plan_at_the_main_path_shapes():
    """The CLI (N = 64) and batch 64 x 64 slots (N = 4096) at V = 6890 fill
    the card with full 8-warp CTAs; at 4096 each CTA takes 32 persons."""
    for N in (64, 4096):
        p = skinning_plan(N, 6890)
        assert p.warps == 8 and p.ctas >= 2 * 132
    assert skinning_plan(4096, 6890).persons == 32


@pytest.mark.parametrize("N", [1, 8, 37, 64, 512, 1024, 4096])
@pytest.mark.parametrize("V", [6890, 129, 1000])
def test_skinning_bwd_plan(N, V):
    """The backward's launch: segments of whole ring stages cover V
    exactly (none empty), person groups cover N; shared memory within the
    232,448 bytes a CTA may take and two 8-warp CTAs an SM; the partials'
    scratch follows the plan; the card has a CTA per SM wherever N and V
    give that many (person group, stage) tiles."""
    p = skinning_bwd_plan(N, V)
    assert p.seg_verts % BWD_SUB == 0
    assert p.segments * p.seg_verts >= V > (p.segments - 1) * p.seg_verts
    assert p.groups * BWD_PERSONS >= N > (p.groups - 1) * BWD_PERSONS
    assert p.smem == skinning_bwd_smem() <= MAX_SMEM
    assert 2 * (p.smem + CTA_RESERVED_SMEM) <= SM_SMEM
    assert p.partial_shape(N) == (None if p.segments == 1
                                  else (p.segments, N, 12, 24))
    assert p.ctas >= min(132, p.groups * -(-V // BWD_SUB))


def test_skinning_bwd_plan_at_the_main_path_shapes():
    """N = 64 (the CLI), 512 (the train steps), 1024 and 4096 (64 x 64
    slots) at V = 6890 fill the 132 SMs within one wave of two CTAs an
    SM; at 4096 the persons alone fill it: one segment, no partials."""
    for N in (64, 512, 1024, 4096):
        assert 132 <= skinning_bwd_plan(N, 6890).ctas <= 2 * 132
    p = skinning_bwd_plan(4096, 6890)
    assert p.segments == 1 and p.partial_shape(4096) is None
