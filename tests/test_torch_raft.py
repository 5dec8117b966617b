"""Port parity for RAFT: romp_tpu_torch.models.raft against
romp_tpu.models.raft on the same numbers. The JAX package's own init at a
64x64 input, carried across by `state_dict_from_jax`; inputs made with
numpy from a seed; the port's NCHW transposed to JAX's NHWC where they
meet. f32 bars are relative to max|ref|."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from romp_tpu.models import raft as jraft
from romp_tpu.models.layers import ParamStore
from romp_tpu_torch.models import raft as traft
from romp_tpu_torch.utils.checkpoint import state_dict_from_jax

torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def weights():
    """JAX's seeded RAFT with the context encoder's BatchNorm statistics
    set away from the identity, and the port's net with the same numbers."""
    jp = {k: np.asarray(v) for k, v in jraft.init_raft_params(
        jax.random.PRNGKey(0), size=64).items()}
    rng = np.random.RandomState(5)
    for k in jp:
        if k.startswith("cnet.") and k.endswith("running_var"):
            jp[k] = (1.0 + rng.rand(*jp[k].shape)).astype(np.float32)
        elif k.startswith("cnet.") and k.endswith("running_mean"):
            jp[k] = (0.2 * rng.randn(*jp[k].shape)).astype(np.float32)
        elif k.endswith(".bias"):
            jp[k] = (0.05 * rng.randn(*jp[k].shape)).astype(np.float32)
    sd = traft.filter_raft_state_dict(state_dict_from_jax(jp))
    net = traft.Raft()
    net.load_state_dict(sd, strict=True)
    return jp, sd, net.eval()


def _frames(n=3, size=64, seed=0):
    """Smooth frames (8x8 blocks plus noise) moving right by 3 pixels a
    frame, RGB in [0, 255]."""
    rng = np.random.RandomState(seed)
    base = np.kron(rng.rand(1, size // 8, size // 8, 3),
                   np.ones((1, 8, 8, 1))) * 235.0
    frames = [np.roll(base, 3 * t, axis=2) for t in range(n)]
    return (np.concatenate(frames) + rng.rand(n, size, size, 3) * 20.0
            ).astype(np.float32)


def test_weight_bridge_finds_every_key_and_shape(weights):
    """JAX's seeded parameters through `state_dict_from_jax` carry every
    key and shape the port's module expects; the port's own init has the
    same; a torch checkpoint's `downsample.1` aliases and counters go."""
    jp, sd, net = weights
    ours = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert set(ours) == set(jp)
    to_torch = {4: (3, 2, 0, 1)}
    for k, v in jp.items():
        shape = v.shape
        if k.endswith(".weight") and v.ndim in to_torch:
            shape = tuple(shape[i] for i in to_torch[v.ndim])
        assert ours[k] == tuple(shape), k
    # the GRU's (1, 5) and (5, 1) kernels keep their orientation
    assert ours["update_block.gru.convz1.weight"] == (128, 384, 1, 5)
    assert ours["update_block.gru.convz2.weight"] == (128, 384, 5, 1)
    init = traft.init_raft_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in init.items()} == ours
    ckpt = dict(init)
    for k in list(init):
        if ".norm3." in k:
            ckpt[k.replace(".norm3.", ".downsample.1.")] = init[k]
        if k.endswith("running_mean"):
            ckpt[k[:-len("running_mean")] + "num_batches_tracked"] = (
                torch.tensor(0))
    assert len(ckpt) > len(init)
    traft.Raft().load_state_dict(traft.filter_raft_state_dict(ckpt),
                                 strict=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_corr_pyramid_matches_jax(dtype):
    """Volume and pools: f32 to 1e-6 of max|ref|. The bf16 pyramid: the
    volume rounded once from f32, equal; its pools, which JAX sums in bf16
    (a rounding an add) and the port in f32 (one rounding), to a few bf16
    steps (2^-6 of max|ref|)."""
    rng = np.random.RandomState(1)
    f1 = rng.randn(2, 8, 8, 32).astype(np.float32)
    f2 = rng.randn(2, 8, 8, 32).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref = jraft.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), jdt)
    ours = traft.build_corr_pyramid(_nchw(f1), _nchw(f2), tdt)
    assert len(ours) == len(ref) == 4
    for i, (o, r) in enumerate(zip(ours, ref)):
        r = np.asarray(r, np.float32)
        o = o.float().numpy().reshape(r.shape)
        if dtype == "float32":
            assert _rel(o, r) <= 1e-6
        elif i == 0:
            np.testing.assert_array_equal(o, r)
        else:
            assert _rel(o, r) <= 2.0 ** -6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", [8, 13])
def test_lookup_matches_onehot(dtype, size):
    """The gather lookup against `corr_lookup_onehot` on the same pyramid
    (JAX's levels, carried across), at 1e-5 of max|ref|: coords inside and
    outside the map (zeros there), levels down to 1x1 (8) and odd sizes
    (13: pools that floor), f32 and bf16 levels."""
    rng = np.random.RandomState(2)
    f1 = rng.randn(2, size, size, 16).astype(np.float32)
    f2 = rng.randn(2, size, size, 16).astype(np.float32)
    coords = (rng.rand(2, size, size, 2) * (size + 12) - 6).astype(
        np.float32)
    coords[0, 0, 0] = [-40.0, 3.0]          # far outside: all taps zero
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    pyramid = jraft.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), jdt)
    ref = np.asarray(jraft.corr_lookup_onehot(pyramid, jnp.asarray(coords)))
    packed = traft.PackedPyramid([
        torch.from_numpy(np.array(level, np.float32)).to(tdt).reshape(
            -1, 1, *level.shape[2:]) for level in pyramid])
    ours = _nhwc(traft.corr_lookup(packed, _nchw(coords)))
    assert ours.shape == ref.shape == (2, size, size, 4 * 81)
    assert _rel(ours, ref) <= 1e-5
    assert np.all(ours[0, 0, 0, :81] == 0.0)


def test_upsample_convex_matches_jax():
    rng = np.random.RandomState(3)
    flow = (rng.randn(2, 5, 6, 2) * 3).astype(np.float32)
    mask = rng.randn(2, 5, 6, 576).astype(np.float32)
    ref = np.asarray(jraft.upsample_flow_convex(jnp.asarray(flow),
                                                jnp.asarray(mask)))
    ours = _nhwc(traft.upsample_flow_convex(_nchw(flow), _nchw(mask)))
    assert ours.shape == ref.shape == (2, 40, 48, 2)
    assert _rel(ours, ref) <= 1e-6


@pytest.mark.parametrize("name,norm", [("fnet", "instance"),
                                       ("cnet", "batch")])
def test_basic_encoder_matches_jax(weights, name, norm):
    jp, _, net = weights
    rng = np.random.RandomState(4)
    x = (rng.rand(2, 64, 64, 3) * 2 - 1).astype(np.float32)
    store = ParamStore({k: jnp.asarray(v) for k, v in jp.items()})
    ref = np.asarray(jax.jit(lambda a: jraft.basic_encoder(
        store, name, a, 256, norm))(jnp.asarray(x)))
    with torch.no_grad():
        ours = _nhwc(getattr(net, name)(_nchw(x)))
    assert ours.shape == ref.shape == (2, 8, 8, 256)
    assert _rel(ours, ref) <= 1e-5


def test_norms_bf16_bit_equal_to_jax():
    """The bf16 mode's norms: instance norm (f32 statistics rounded to
    bf16, bf16 arithmetic) and the folded BatchNorm equal JAX's bf16 ones
    bit for bit."""
    from romp_tpu.models.layers import batch_norm

    rng = np.random.RandomState(6)
    x = (rng.randn(2, 12, 12, 16) * 3 + 1).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    xt = _nchw(x).bfloat16()
    ref = np.asarray(jraft.instance_norm(xb), np.float32)
    ours = _nhwc(traft.InstanceNorm()(xt).float())
    np.testing.assert_array_equal(ours, ref)
    bn = {"weight": 1 + 0.1 * rng.randn(16), "bias": 0.1 * rng.randn(16),
          "running_mean": 0.3 * rng.randn(16),
          "running_var": 1 + rng.rand(16)}
    bn = {k: v.astype(np.float32) for k, v in bn.items()}
    store = ParamStore({f"n.{k}": jnp.asarray(v) for k, v in bn.items()},
                       act_dtype=jnp.bfloat16)
    ref = np.asarray(batch_norm(store, "n", xb), np.float32)
    mod = traft.BatchNorm(16)
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in bn.items()})
    with torch.no_grad():
        ours = _nhwc(mod(xt).float())
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("iters", [2, 4])
def test_raft_forward_matches_jax(weights, iters):
    """flow_low and flow_up within 1e-4 of max|ref|, f32."""
    jp, _, net = weights
    fr = _frames(2)
    store = ParamStore({k: jnp.asarray(v) for k, v in jp.items()})
    lo, up = jax.jit(lambda a, b: jraft.raft_forward(store, a, b, iters))(
        jnp.asarray(fr[:1]), jnp.asarray(fr[1:]))
    with torch.no_grad():
        tlo, tup = traft.raft_forward(net, torch.from_numpy(fr[:1]),
                                      torch.from_numpy(fr[1:]), iters)
    assert _nhwc(tlo).shape == np.asarray(lo).shape == (1, 8, 8, 2)
    assert _nhwc(tup).shape == np.asarray(up).shape == (1, 64, 64, 2)
    assert _rel(_nhwc(tlo), lo) <= 1e-4
    assert _rel(_nhwc(tup), up) <= 1e-4
    assert np.abs(np.asarray(up)).max() > 0.1     # the flow is not zero


def test_raft_forward_seq_matches_pairwise_and_jax(weights):
    """Sequence form: fnet once per frame, the same flows as the pairwise
    form (1e-6) and as JAX's sequence form (1e-4)."""
    jp, _, net = weights
    fr = _frames(3)
    store = ParamStore({k: jnp.asarray(v) for k, v in jp.items()})
    _, ref = jax.jit(lambda a: jraft.raft_forward_seq(store, a, 3))(
        jnp.asarray(fr))
    with torch.no_grad():
        _, seq = traft.raft_forward_seq(net, torch.from_numpy(fr), 3)
        _, pair = traft.raft_forward(net, torch.from_numpy(fr[:-1]),
                                     torch.from_numpy(fr[1:]), 3)
    assert seq.shape == (2, 2, 64, 64)
    assert _rel(seq, pair) <= 1e-6
    assert _rel(_nhwc(seq), ref) <= 1e-4


@pytest.mark.parametrize("size", [24, 40, 64, 96])
def test_resize_matches_jax_image_resize(size):
    """`resize_bilinear` (antialiased when it shrinks) against
    jax.image.resize "bilinear", down and up from 64: 1e-5 of max|ref|."""
    x = np.random.RandomState(7).rand(2, 64, 64, 3).astype(np.float32) * 255
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, size, size, 3),
                                      "bilinear"))
    ours = _nhwc(traft.resize_bilinear(_nchw(x), size))
    assert _rel(ours, ref) <= 1e-5


@pytest.mark.parametrize("sequence", [False, True])
def test_trace_flow_fn_matches_jax(weights, sequence):
    """make_trace_flow_fn with flow_input_size (32) below the 64x64 frames
    (the antialiased resize of the frames) and out_size 16 (of flow_up):
    within 1e-4 of max|ref|, f32; (T, 16, 16, 2)."""
    jp, sd, _ = weights
    fr = _frames(3)
    kw = dict(iters=3, out_size=16, flow_input_size=32, sequence=sequence)
    jfn = jraft.make_trace_flow_fn({k: jnp.asarray(v) for k, v in jp.items()},
                                   **kw)
    tfn = traft.make_trace_flow_fn(sd, device="cpu", **kw)
    if sequence:
        assert tfn.takes_sequence
        ref, ours = jfn(jnp.asarray(fr)), tfn(torch.from_numpy(fr))
    else:
        ref = jfn(jnp.asarray(fr[:-1]), jnp.asarray(fr[1:]))
        ours = tfn(torch.from_numpy(fr[:-1]), torch.from_numpy(fr[1:]))
    assert ours.shape == (2, 16, 16, 2)
    assert _rel(ours.numpy(), ref) <= 1e-4


def test_trace_flow_fn_bf16_within_bf16_noise(weights):
    """The bf16 mode (the CLI default). Each of its pieces is JAX's bf16
    function (the norms bit-equal above; a conv's bf16 output, and its bias
    added in bf16, equal unless f32 summation order moves a value across a
    rounding boundary), but such flips spread through the encoders and the
    recurrence, so the flow is held to the scale of bf16 noise, `noise` =
    |JAX bf16 - JAX f32|. The port's bf16 flow is as far from its f32 flow
    as that, and two bf16 flows that are each within `noise` of the f32
    flow (the two f32 flows agree to 1e-4) are within 2 x noise of each
    other: the bar, at the largest element and on average (measured at 3
    iterations: 0.97 and 0.90 of noise; at 8, 1.56 and 1.38). And the
    port's bf16 mode is not its f32 mode."""
    jp, sd, _ = weights
    fr = _frames(3)
    kw = dict(iters=3, out_size=16, flow_input_size=64, sequence=True)
    jparams = {k: jnp.asarray(v) for k, v in jp.items()}
    j32 = np.asarray(jraft.make_trace_flow_fn(jparams, **kw)(jnp.asarray(fr)))
    j16 = np.asarray(jraft.make_trace_flow_fn(
        jparams, compute_dtype="bfloat16", **kw)(jnp.asarray(fr)))
    t32 = traft.make_trace_flow_fn(sd, device="cpu", **kw)(
        torch.from_numpy(fr)).numpy()
    t16 = traft.make_trace_flow_fn(sd, device="cpu", compute_dtype="bfloat16",
                                   **kw)(torch.from_numpy(fr)).numpy()
    scale = np.abs(j16).max()
    noise = np.abs(j16 - j32) / scale
    own = np.abs(t16 - t32) / scale
    err = np.abs(t16 - j16) / scale
    assert np.isfinite(t16).all()
    assert own.max() <= 2 * noise.max() and own.mean() <= 2 * noise.mean()
    assert err.max() <= 2 * noise.max() and err.mean() <= 2 * noise.mean()
    assert own.max() > 1e-3
