"""Port parity for the TRACE head and its pieces: romp_tpu_torch vs romp_tpu
on the same numbers. The JAX package's own init at map_size 32, clip length
2, carried across by `state_dict_from_jax`; inputs made with numpy from a
seed; the port's NCHW transposed to JAX's NHWC where they meet."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from romp_tpu.models import layers as jlayers
from romp_tpu.models import trace as jtrace
from romp_tpu.models.bev import cam3dmap_anchor as jax_anchor
from romp_tpu.ops.centermap import parse_centermap3d as jax_parse3d
from romp_tpu.ops.projection import perspective_projection as jax_persp
from romp_tpu.smpl.assets import synthetic_assets
from romp_tpu.smpl.body_model import SmplModel as JaxSmpl
from romp_tpu.smpl.body_model import smpla_forward as jax_smpla
from romp_tpu_torch.models import trace as ttrace
from romp_tpu_torch.models.layers import (
    BasicBlock3d, Conv1d, Conv3d, LayerOpts, cast_bf16,
)
from romp_tpu_torch.ops.centermap import parse_centermap3d
from romp_tpu_torch.ops.projection import perspective_projection
from romp_tpu_torch.smpl.body_model import (
    SmplModel, smpl_forward, smpla_forward,
)
from romp_tpu_torch.utils.checkpoint import state_dict_from_jax

torch.set_num_threads(2)
MAP = 32
CLIP = 2
MIXED = LayerOpts(compute_dtype=torch.bfloat16)
BF16_ACT = LayerOpts(compute_dtype=torch.bfloat16, act_dtype=torch.bfloat16)
MAP_FIELDS = ("center_maps_3d", "center_maps_fv", "cam_maps_3d",
              "motion_maps_3d", "motion_maps_fv", "mesh_feature_maps",
              "cam_motion_maps", "cam_rot_maps")


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _mixed_close(ours, ref):
    """The mixed conv's output is rounded to bf16, and f32 summation order
    can move a value across a rounding boundary: allow one bf16 step (8
    mantissa bits: up to 2^-7 of max|ref| for a value near the max) at
    rare elements, and hold the rest to f32 noise."""
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    scale = np.abs(ref).max()
    err = np.abs(ours - ref) / scale
    assert err.max() <= 2.0 ** -7, err.max()
    assert (err > 1e-5).mean() <= 0.01, (err > 1e-5).mean()


@pytest.fixture(scope="module")
def head():
    jp = jtrace.init_trace_params(jax.random.PRNGKey(0), clip_length=CLIP,
                                  map_size=MAP)
    jp = {k: np.asarray(v) for k, v in jp.items()}
    net = ttrace.TraceNet(None, MAP)
    net.load_state_dict(state_dict_from_jax(jp), strict=True)
    return jp, net.eval()


def test_state_dict_keys_and_shapes_are_jax(head):
    jp, net = head
    ours = {k: tuple(v.shape) for k, v in net.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    assert set(ours) == set(jp)
    to_torch = {3: (2, 1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}
    for k, v in jp.items():
        shape = v.shape
        if k.endswith(".weight") and v.ndim in to_torch:
            shape = tuple(shape[i] for i in to_torch[v.ndim])
        assert ours[k] == tuple(shape), k
    # the port's own init has the same keys and shapes
    sd = ttrace.init_trace_params(torch.Generator().manual_seed(0),
                                  map_size=MAP, backbone=None)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in net.state_dict().items()}


def test_cam_anchor_and_coord_maps():
    np.testing.assert_array_equal(ttrace.trace_cam_anchor(),
                                  jtrace.trace_cam_anchor())
    np.testing.assert_array_equal(ttrace.cam3dmap_anchor(60.0, 64),
                                  jax_anchor(60.0, 64))
    ours = ttrace.coord_maps_3d_zeroz(16, 8).numpy()
    np.testing.assert_array_equal(ours.transpose(0, 2, 3, 4, 1),
                                  jtrace.coord_maps_3d_zeroz(16, 8))


@pytest.mark.parametrize("mixed", [False, True])
def test_conv1d_matches_jax(mixed):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 40, 17).astype(np.float32)            # (B, C, W)
    w = (rng.randn(24, 40, 3) * 0.2).astype(np.float32)     # (O, I, L)
    b = rng.randn(24).astype(np.float32)
    conv = Conv1d(40, 24, 3, bias=True)
    conv.load_state_dict({"weight": torch.from_numpy(w),
                          "bias": torch.from_numpy(b)})
    store = jlayers.ParamStore(
        {"c.weight": jnp.asarray(w.transpose(2, 1, 0)), "c.bias": b},
        compute_dtype=jnp.bfloat16 if mixed else jnp.float32)
    ref = np.asarray(jlayers.conv1d(store, "c", jnp.asarray(
        x.transpose(0, 2, 1)), 24, 3, bias=True)).transpose(0, 2, 1)
    with torch.no_grad():
        ours = conv(torch.from_numpy(x), MIXED if mixed else LayerOpts())
    if mixed:
        _mixed_close(ours, ref)
    else:
        assert _rel(ours, ref) <= 1e-5


@pytest.mark.parametrize("mixed", [False, True])
def test_conv3d_matches_jax(mixed):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 3, 6, 5, 7).astype(np.float32)        # (B, C, D, H, W)
    w = (rng.randn(3, 3, 3, 3, 3) * 0.3).astype(np.float32)
    conv = Conv3d(3, 3, 3)
    conv.load_state_dict({"weight": torch.from_numpy(w)})
    store = jlayers.ParamStore(
        {"c.weight": jnp.asarray(w.transpose(2, 3, 4, 1, 0))},
        compute_dtype=jnp.bfloat16 if mixed else jnp.float32)
    ref = np.asarray(jlayers.conv3d(store, "c", jnp.asarray(
        x.transpose(0, 2, 3, 4, 1)), 3, 3)).transpose(0, 4, 1, 2, 3)
    with torch.no_grad():
        ours = conv(torch.from_numpy(x), MIXED if mixed else LayerOpts())
    if mixed:
        _mixed_close(ours, ref)
    else:
        assert _rel(ours, ref) <= 1e-5


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("C", [1, 3])
def test_basic_block_3d_matches_jax_zband(mixed, C):
    """The port's plain Conv3d block against the JAX z-band block."""
    rng = np.random.RandomState(3 + C)
    x = rng.randn(2, C, 8, 6, 5).astype(np.float32)
    params = {}
    for i in (1, 2):
        params[f"b.conv{i}.weight"] = (rng.randn(3, 3, 3, C, C) * 0.3
                                       ).astype(np.float32)
        params[f"b.bn{i}.weight"] = (1 + 0.1 * rng.randn(C)).astype(np.float32)
        params[f"b.bn{i}.bias"] = (0.1 * rng.randn(C)).astype(np.float32)
        params[f"b.bn{i}.running_mean"] = (0.1 * rng.randn(C)).astype(
            np.float32)
        params[f"b.bn{i}.running_var"] = (1 + rng.rand(C)).astype(np.float32)
    block = BasicBlock3d(C, C).eval()
    sd = state_dict_from_jax(params)
    block.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    store = jlayers.ParamStore(
        {k: jnp.asarray(v) for k, v in params.items()},
        compute_dtype=jnp.bfloat16 if mixed else jnp.float32)
    ref = np.asarray(jlayers.basic_block_3d(
        store, "b", jnp.asarray(x.transpose(0, 2, 3, 4, 1)), C)
    ).transpose(0, 4, 1, 2, 3)
    with torch.no_grad():
        ours = block(torch.from_numpy(x), MIXED if mixed else LayerOpts())
    if mixed:
        # a bf16 flip in conv1 reaches conv2's rounded input; it stays
        # within a few bf16 steps of max|ref| and at few elements
        err = np.abs(ours.numpy() - ref) / np.abs(ref).max()
        assert err.max() <= 2.0 ** -6 and (err > 1e-5).mean() <= 0.05
    else:
        assert _rel(ours, ref) <= 1e-5


def _clip_inputs(seed, T=CLIP):
    rng = np.random.RandomState(seed)
    feats = rng.randn(T + 1, 32, MAP, MAP).astype(np.float32)
    flows = (rng.randn(T, 2, MAP, MAP) * 0.5).astype(np.float32)
    return feats, flows


def _jax_maps(jp, feats, flows, hidden):
    return jtrace.trace_forward_maps(
        jlayers.ParamStore({k: jnp.asarray(v) for k, v in jp.items()}),
        jnp.asarray(feats.transpose(0, 2, 3, 1)),
        jnp.asarray(flows.transpose(0, 2, 3, 1)), hidden,
        temp_clip_length=CLIP)


def test_trace_forward_maps_match_jax_two_clips(head):
    """All 8 maps in f32 within 1e-4 of max|ref|, on a first clip (ConvGRU
    warm start) and a second that carries the hidden state."""
    jp, net = head
    jhidden, thidden = None, None
    for clip in range(2):
        feats, flows = _clip_inputs(10 + clip)
        jmaps, jhidden = _jax_maps(jp, feats, flows, jhidden)
        with torch.no_grad():
            tmaps, thidden = ttrace.trace_forward_maps(
                net, torch.from_numpy(feats), torch.from_numpy(flows),
                thidden, CLIP)
        for name in MAP_FIELDS:
            ours, ref = getattr(tmaps, name).numpy(), np.asarray(
                getattr(jmaps, name))
            assert ours.shape == ref.shape, name
            assert _rel(ours, ref) <= 1e-4, (clip, name, _rel(ours, ref))
        for h_t, h_j in zip(thidden, jhidden):
            assert _rel(h_t.numpy().transpose(0, 2, 3, 1), h_j) <= 1e-4


def test_regressors_match_jax(head):
    jp, net = head
    rng = np.random.RandomState(5)
    feats = rng.randn(3, 4, 128).astype(np.float32)
    cams = rng.randn(3, 4, 3).astype(np.float32)
    store = jlayers.ParamStore({k: jnp.asarray(v) for k, v in jp.items()})
    with torch.no_grad():
        ours = ttrace.trace_regress_trajectory(net, torch.from_numpy(feats))
        trans = ttrace.trace_regress_trans(net, torch.from_numpy(cams),
                                           torch.from_numpy(feats))
    assert ours.shape == (3, 4, 159)
    assert _rel(ours, jtrace.trace_regress_trajectory(
        store, jnp.asarray(feats))) <= 1e-5
    assert _rel(trans, jtrace.trace_regress_trans(
        store, jnp.asarray(cams), jnp.asarray(feats))) <= 1e-5


def test_parse_centermap3d_matches_jax():
    """Compared as sets of (z, y, x): top-k tie order may differ."""
    rng = np.random.RandomState(6)
    cmap = rng.randn(2, 12, 16, 16).astype(np.float32)
    ref = jax_parse3d(jnp.asarray(cmap), 10, 0.5)
    ours = parse_centermap3d(torch.from_numpy(cmap), 10, 0.5)
    for b in range(2):
        jm, tm = np.asarray(ref.mask[b]), ours.mask[b].numpy()
        jset = {tuple(z) for z in np.asarray(ref.zyx[b])[jm].astype(int)}
        tset = {tuple(z) for z in ours.zyx[b].numpy()[tm].astype(int)}
        assert jset == tset and len(tset) > 0
        np.testing.assert_array_equal(
            np.sort(np.asarray(ref.scores[b])), np.sort(ours.scores[b]))
    flat = ours.zyx[..., 1] * 16 + ours.zyx[..., 2]
    np.testing.assert_array_equal(ours.flat_inds.numpy(), flat.numpy())


def test_perspective_projection_matches_jax():
    rng = np.random.RandomState(7)
    pts = rng.randn(5, 71, 3).astype(np.float32)
    trans = (rng.randn(5, 3) + [0, 0, 6]).astype(np.float32)
    for normalized in (True, False):
        ref = jax_persp(jnp.asarray(pts), jnp.asarray(trans), 548.0, 512.0,
                        normalized)
        ours = perspective_projection(torch.from_numpy(pts),
                                      torch.from_numpy(trans), 548.0, 512.0,
                                      normalized)
        assert _rel(ours, ref) <= 1e-6


def test_smpla_forward_matches_jax():
    """Adult (11 betas) and baby (SMIL, 10) models, betas[:, 10] on both
    sides of 0.8. Bar 1e-4 (the port's SMPL bar)."""
    adult = synthetic_assets(seed=0, num_betas=11)
    baby = synthetic_assets(seed=1, num_betas=10)
    rng = np.random.RandomState(8)
    betas = (rng.randn(4, 11) * 0.5).astype(np.float32)
    betas[:, 10] = [0.2, 0.9, 0.79, 1.5]
    pose = (rng.randn(4, 72) * 0.3).astype(np.float32)
    jv, jj = jax_smpla(JaxSmpl.from_assets(adult), JaxSmpl.from_assets(baby),
                       jnp.asarray(betas), jnp.asarray(pose))
    tv, tj = smpla_forward(SmplModel(adult), SmplModel(baby),
                           torch.from_numpy(betas), torch.from_numpy(pose))
    assert tv.shape == (4, 6890, 3) and tj.shape == (4, 71, 3)
    assert _rel(tv, jv) <= 1e-4 and _rel(tj, jj) <= 1e-4
    # rows above 0.8 took the baby model, the others the adult
    v_adult, _ = smpl_forward(SmplModel(adult), torch.from_numpy(betas),
                              torch.from_numpy(pose), root_align=True)
    v_baby, _ = smpl_forward(SmplModel(baby), torch.from_numpy(betas[:, :10]),
                             torch.from_numpy(pose), root_align=True)
    for i, baby_row in enumerate((False, True, False, True)):
        assert torch.equal(tv[i], (v_baby if baby_row else v_adult)[i])


def _bf16_act_close(ours, ref):
    """Single bf16-activation layers: JAX's dtype, and bit-equal but at a
    few elements where a sum within f32 summation noise of a bf16 rounding
    boundary rounds the other way (up to one step of max|ref|, 2^-7; at
    most 1% of the elements differ: the 3D block's second conv reads the
    first one's flips)."""
    assert str(ours.dtype).split(".")[-1] == str(ref.dtype), (
        ours.dtype, ref.dtype)
    ours = ours.float().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    err = np.abs(ours - ref) / np.abs(ref).max()
    assert err.max() <= 2.0 ** -7 and (err > 0).mean() <= 0.01, (
        err.max(), (err > 0).mean())


@pytest.mark.parametrize("bias", [False, True])
def test_conv1d_bf16_act_matches_jax(bias):
    """act_dtype=bfloat16 (`layers.py:221-227`): the bf16 conv's output, a
    bf16 array; with a bias (f32) `y + bias` promotes it to f32, as in
    JAX, so the next layer gets f32."""
    rng = np.random.RandomState(11)
    x = rng.randn(2, 40, 17).astype(np.float32)
    w = (rng.randn(24, 40, 3) * 0.2).astype(np.float32)
    b = rng.randn(24).astype(np.float32)
    conv = Conv1d(40, 24, 3, bias=bias)
    conv.load_state_dict({"weight": torch.from_numpy(w),
                          **({"bias": torch.from_numpy(b)} if bias else {})})
    cast_bf16(conv)
    params = {"c.weight": jnp.asarray(w.transpose(2, 1, 0))}
    if bias:
        params["c.bias"] = jnp.asarray(b)
    store = jlayers.ParamStore(params, compute_dtype=jnp.bfloat16,
                               act_dtype=jnp.bfloat16)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = jlayers.conv1d(store, "c", xb.transpose(0, 2, 1), 24, 3,
                         bias=bias).transpose(0, 2, 1)
    assert ref.dtype == (jnp.float32 if bias else jnp.bfloat16)
    with torch.no_grad():
        ours = conv(torch.from_numpy(np.array(xb.astype(jnp.float32)))
                    .bfloat16(), BF16_ACT)
    _bf16_act_close(ours, ref)


@pytest.mark.parametrize("f32_input", [False, True])
@pytest.mark.parametrize("C", [1, 3])
def test_basic_block_3d_bf16_act_matches_jax_zband(C, f32_input):
    """The port's Conv3d block against the JAX z-band block under
    act_dtype=bfloat16: bf16 convs, BN in bf16, the residual cast to bf16
    before the add (`layers.py:329`), so a bf16 block out of an f32 input
    too (the cam maps' refiner reads the f32 coord-map sum)."""
    rng = np.random.RandomState(13 + C)
    x = rng.randn(2, C, 8, 6, 5).astype(np.float32)
    params = {}
    for i in (1, 2):
        params[f"b.conv{i}.weight"] = (rng.randn(3, 3, 3, C, C) * 0.3
                                       ).astype(np.float32)
        params[f"b.bn{i}.weight"] = (1 + 0.1 * rng.randn(C)).astype(np.float32)
        params[f"b.bn{i}.bias"] = (0.1 * rng.randn(C)).astype(np.float32)
        params[f"b.bn{i}.running_mean"] = (0.1 * rng.randn(C)).astype(
            np.float32)
        params[f"b.bn{i}.running_var"] = (1 + rng.rand(C)).astype(np.float32)
    block = BasicBlock3d(C, C).eval()
    sd = state_dict_from_jax(params)
    block.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    cast_bf16(block)
    store = jlayers.ParamStore(
        {k: jnp.asarray(v) for k, v in params.items()},
        compute_dtype=jnp.bfloat16, act_dtype=jnp.bfloat16)
    jx = jnp.asarray(x.transpose(0, 2, 3, 4, 1))
    tx = torch.from_numpy(x)
    if not f32_input:
        jx = jx.astype(jnp.bfloat16)
        tx = tx.bfloat16()
    ref = jlayers.basic_block_3d(store, "b", jx, C).transpose(0, 4, 1, 2, 3)
    assert ref.dtype == jnp.bfloat16
    with torch.no_grad():
        ours = block(tx, BF16_ACT)
    _bf16_act_close(ours, ref)


def test_trace_forward_maps_bf16_act_match_jax(head):
    """act_dtype=bfloat16, the whole head on one clip: the deform in bf16
    (bf16 features and weight, f32 offsets; JAX's rounding points, see
    test_torch_deform.py), the ConvGRU's f32 hidden state promoted as in
    JAX, bf16 maps. Each block agrees with JAX's bit for bit but at rare
    rounding flips (0.002-0.03% of the elements of each of
    cam_motion_head's blocks fed the same input), and the deep random
    head spreads them (six 3x3 blocks reach half of cam_motion_maps'
    elements). So each map is held to JAX's own bf16-act-vs-f32 distance:
    the mean difference within 0.75x of it, the largest within 1.5x
    (measured: cam_motion_maps' mean difference at 0.61x, the others'
    lower)."""
    jp, net = head
    net = ttrace.TraceNet(None, MAP)
    net.load_state_dict(state_dict_from_jax(jp), strict=True)
    cast_bf16(net.eval())
    feats, flows = _clip_inputs(21)
    jf32, _ = _jax_maps(jp, feats, flows, None)
    jbf16, jhidden = jtrace.trace_forward_maps(
        jlayers.ParamStore({k: jnp.asarray(v) for k, v in jp.items()},
                           compute_dtype=jnp.bfloat16,
                           act_dtype=jnp.bfloat16),
        jnp.asarray(feats.transpose(0, 2, 3, 1)),
        jnp.asarray(flows.transpose(0, 2, 3, 1)), None,
        temp_clip_length=CLIP)
    with torch.no_grad():
        tbf16, thidden = ttrace.trace_forward_maps(
            net, torch.from_numpy(feats), torch.from_numpy(flows), None,
            CLIP, BF16_ACT)
    for name in MAP_FIELDS:
        ref, ours = getattr(jbf16, name), getattr(tbf16, name)
        assert str(ours.dtype).split(".")[-1] == str(ref.dtype), name
        ref = np.asarray(ref.astype(jnp.float32))
        f32 = np.asarray(getattr(jf32, name))
        d = np.abs(ours.float().numpy() - ref) / np.abs(ref).max()
        gap = np.abs(f32 - ref) / np.abs(ref).max()
        assert d.max() <= 1.5 * gap.max() and d.mean() <= 0.75 * gap.mean(), (
            name, d.max(), d.mean(), gap.max(), gap.mean())
    for h_t, h_j in zip(thidden, jhidden):
        assert h_t.dtype == torch.float32 and h_j.dtype == jnp.float32
