"""Port parity for the fused BasicBlock chain: weight packing, the plain
chain against `reference_basic_chain`, and a tiny HRNet module with
fuse_chains against the unfused one (CPU: the wrapper takes the plain
version)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from romp_tpu.models.layers import ParamStore
from romp_tpu.ops.pallas_fuse import (
    pack_chain_weights as jax_pack, reference_basic_chain,
)
from romp_tpu_torch.models.hrnet import Branch, HRModule
from romp_tpu_torch.models.layers import LayerOpts
from romp_tpu_torch.ops.fused_chain import (
    CHUNK, MIN_CTAS, SMEM_LIMIT, TILE_W, TILES, basic_chain,
    basic_chain_plain, conv_pass, conv_pass_plain, launch_plan,
    pack_chain_weights, smem_bytes,
)
from romp_tpu_torch.utils.checkpoint import state_dict_from_jax

torch.set_num_threads(2)
MIXED = LayerOpts(compute_dtype=torch.bfloat16)


def _chain_params(rng, C, blocks, prefix="br"):
    """JAX flat dict (HWIO) of a BasicBlock chain with non-trivial BN."""
    params = {}
    for n in range(blocks):
        for conv, bn in ((f"{prefix}.{n}.conv1", f"{prefix}.{n}.bn1"),
                         (f"{prefix}.{n}.conv2", f"{prefix}.{n}.bn2")):
            params[f"{conv}.weight"] = (
                rng.randn(3, 3, C, C).astype(np.float32) * 0.05)
            params[f"{bn}.weight"] = 1.0 + 0.1 * rng.randn(C).astype(np.float32)
            params[f"{bn}.bias"] = 0.1 * rng.randn(C).astype(np.float32)
            params[f"{bn}.running_mean"] = 0.1 * rng.randn(C).astype(np.float32)
            params[f"{bn}.running_var"] = (
                1.0 + 0.2 * rng.rand(C)).astype(np.float32)
    return params


def _rel_err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) + 1e-9)


def test_pack_chain_weights_matches_jax():
    params = _chain_params(np.random.RandomState(1), C=32, blocks=3)
    jw, jsc, jsh = jax_pack({k: jnp.asarray(v) for k, v in params.items()},
                            "br", 3)
    w, sc, sh = pack_chain_weights(state_dict_from_jax(params), "br", 3)
    assert w.dtype == torch.bfloat16 and tuple(w.shape) == (3, 2, 96, 96)
    np.testing.assert_array_equal(w.float().numpy(),
                                  np.asarray(jw.astype(jnp.float32)))
    np.testing.assert_allclose(sc.numpy(), np.asarray(jsc), rtol=1e-6)
    np.testing.assert_allclose(sh.numpy(), np.asarray(jsh), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("C,H", [(32, 32), (64, 16)])
def test_basic_chain_plain_matches_reference(C, H):
    """Each block, fed the reference's own input to it, within 5e-4 relative
    (the bar of tests/test_pallas_fuse.py:62); the whole chain within 2e-3.

    Why per block: the chain rounds every conv input to bf16, so an f32
    sum taken in another order lands a value on the other side of a bf16
    rounding boundary now and then, and the next convs spread that step.
    Over two blocks at (64, 16) that reaches 7.6e-4 here, and the JAX
    package's own kernel is 4.0e-4 from this reference."""
    rng = np.random.RandomState(0)
    blocks = 2
    x = rng.randn(2, H, H, C).astype(np.float32)
    w = jnp.asarray(rng.randn(blocks, 2, 3 * C, 3 * C).astype(np.float32)
                    * 0.05).astype(jnp.bfloat16)
    sc = (1.0 + 0.1 * rng.randn(blocks, 2, C)).astype(np.float32)
    sh = (0.1 * rng.randn(blocks, 2, C)).astype(np.float32)
    tw = torch.from_numpy(np.array(w.astype(jnp.float32))).to(torch.bfloat16)

    def ref(xin, n0, n1):
        return np.array(reference_basic_chain(
            jnp.asarray(xin), w[n0:n1], jnp.asarray(sc[n0:n1]),
            jnp.asarray(sh[n0:n1]), n1 - n0))

    def ours(xin, n0, n1):
        return basic_chain_plain(
            torch.from_numpy(xin).permute(0, 3, 1, 2).contiguous(),
            tw[n0:n1], torch.from_numpy(sc[n0:n1]),
            torch.from_numpy(sh[n0:n1]), n1 - n0).permute(0, 2, 3, 1).numpy()

    xin = x
    for n in range(blocks):
        r = ref(xin, n, n + 1)
        assert _rel_err(ours(xin, n, n + 1), r) < 5e-4
        xin = r
    assert _rel_err(ours(x, 0, blocks), ref(x, 0, blocks)) < 2e-3


def test_basic_chain_takes_plain_on_cpu():
    rng = np.random.RandomState(3)
    w, sc, sh = pack_chain_weights(
        state_dict_from_jax(_chain_params(rng, C=16, blocks=2)), "br", 2)
    x = torch.from_numpy(rng.randn(1, 16, 8, 8).astype(np.float32))
    before = conv_pass.launches
    np.testing.assert_array_equal(basic_chain(x, w, sc, sh, 2).numpy(),
                                  basic_chain_plain(x, w, sc, sh, 2).numpy())
    args = (x, w[0, 1], sc[0, 1], sh[0, 1], x)
    np.testing.assert_array_equal(conv_pass(*args).numpy(),
                                  conv_pass_plain(*args).numpy())
    assert conv_pass.launches == before   # no kernel launch on the CPU


def test_hr_module_fused_matches_unfused():
    """As tests/test_pallas_fuse.py:80-115: a tiny 2-branch module with
    its weights from the JAX package's init, fused vs unfused (mixed)."""
    from romp_tpu.models.hrnet import hr_module

    channels = (16, 32)
    st = ParamStore(rng=jax.random.PRNGKey(0))
    hr_module(st, "m", [jnp.zeros((1, 16, 16, 16)), jnp.zeros((1, 8, 8, 32))],
              channels, blocks=2)
    sd = {k[len("m."):]: v for k, v in state_dict_from_jax(
        {k: np.asarray(v) for k, v in st.params.items()}).items()}
    module = HRModule(channels, blocks=2)
    module.load_state_dict(sd, strict=True)
    module.eval()
    for branch in module.branches:
        branch.pack()
    rng = np.random.RandomState(2)
    xs = [torch.from_numpy(rng.randn(2, 16, 16, 16).astype(np.float32)),
          torch.from_numpy(rng.randn(2, 32, 8, 8).astype(np.float32))]
    with torch.inference_mode():
        base = module(xs, MIXED)
        fused = module(xs, LayerOpts(compute_dtype=torch.bfloat16,
                                     fuse_chains=True))
    for a, b in zip(base, fused):
        assert _rel_err(b, a) < 2e-3


HRNET_BRANCHES = [(32, 128), (64, 64), (128, 32), (256, 16)]  # (C, H)


@pytest.mark.parametrize("B", [1, 2, 64])
@pytest.mark.parametrize("C,H", HRNET_BRANCHES)
def test_launch_plan_fills_the_card_at_hrnet_shapes(B, C, H):
    """At every 512x512 HRNet branch shape, batch 1, 2 and 64: the plan
    fits a block's shared memory, its K split tiles the chunks of K
    exactly, and it gives at least 128 CTAs (about one wave of the H100's
    132 SMs)."""
    _check_plan(B, C, H, H)
    assert launch_plan(B, C, H, H).ctas >= MIN_CTAS


@pytest.mark.parametrize("B,C,H,W", [(1, 16, 13, 7), (2, 40, 20, 33),
                                     (1, 16, 8, 8), (3, 8, 1, 1)])
def test_launch_plan_ragged_shapes(B, C, H, W):
    _check_plan(B, C, H, W)


def _check_plan(B, C, H, W):
    plan = launch_plan(B, C, H, W)
    assert (plan.tile_h, plan.tile_n) in TILES
    assert plan.smem == smem_bytes(plan.tile_h, plan.tile_n) <= SMEM_LIMIT
    chunks = -(-C // CHUNK)
    assert plan.ksplit >= 1 and chunks % plan.ksplit == 0
    assert plan.ctas == (B * -(-H // plan.tile_h) * -(-W // TILE_W)
                         * -(-C // plan.tile_n) * plan.ksplit)
    assert plan.tile_n == 32 or C % plan.tile_n == 0



@pytest.mark.parametrize("C,H,blocks", [(32, 32, 2), (64, 16, 1)])
def test_basic_chain_plain_bf16_matches_reference(C, H, blocks):
    """bf16 in and out (the bf16-activation path): the JAX chain widens its
    bf16 input to f32 and rounds its result to bf16 (`pallas_fuse.py:
    145-146, 174`); `reference_basic_chain` on the bf16 input is its XLA
    twin. The plain chain (the kernel's CPU twin) keeps that contract: a
    bf16 result, within the f32 chain's bar (2e-3) plus one bf16 step of
    max|ref| (2^-8) for the final rounding, and bit-equal to the f32 chain
    on the widened input, rounded."""
    rng = np.random.RandomState(C + blocks)
    x = jnp.asarray(rng.randn(2, H, H, C).astype(np.float32)).astype(
        jnp.bfloat16)
    w = jnp.asarray(rng.randn(blocks, 2, 3 * C, 3 * C).astype(np.float32)
                    * 0.05).astype(jnp.bfloat16)
    sc = (1.0 + 0.1 * rng.randn(blocks, 2, C)).astype(np.float32)
    sh = (0.1 * rng.randn(blocks, 2, C)).astype(np.float32)
    ref = reference_basic_chain(x, w, jnp.asarray(sc), jnp.asarray(sh),
                                blocks)
    assert ref.dtype == jnp.bfloat16
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).permute(
        0, 3, 1, 2).contiguous().bfloat16()
    tw = torch.from_numpy(np.array(w.astype(jnp.float32))).bfloat16()
    args = (tw, torch.from_numpy(sc), torch.from_numpy(sh), blocks)
    ours = basic_chain(tx, *args)            # the CPU takes the plain twin
    assert ours.dtype == torch.bfloat16
    assert torch.equal(ours, basic_chain_plain(tx.float(), *args).bfloat16())
    assert _rel_err(ours.float().permute(0, 2, 3, 1).numpy(),
                    np.asarray(ref.astype(jnp.float32))) < 2e-3 + 2.0 ** -8


def test_branch_in_train_mode_runs_unfused():
    """The chain kernel is inference only (the reference turns fuse_chains
    off in train mode, `layers.py:55`): a Branch in train mode with
    fuse_chains runs its blocks one by one, with batch statistics, as the
    unfused Branch does, and carries the graph."""
    torch.manual_seed(0)
    branch = Branch(16, 2)
    branch.pack()
    x = torch.randn(2, 16, 8, 8)
    fused = LayerOpts(compute_dtype=torch.bfloat16, fuse_chains=True)
    branch.train()
    out = branch(x, fused)
    assert out.requires_grad and out.grad_fn is not None
    unfused = branch(x, MIXED)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  unfused.detach().numpy())
    branch.eval()
    with torch.no_grad():
        inference = branch(x, fused)      # packed kernel operands (plain)
    assert not torch.equal(inference, out.detach())
