"""Port parity for the ROMP network, center parsing, projection and the
pipeline: romp_tpu_torch vs romp_tpu at 64x64 on the tiny backbone, with
the JAX package's own init carried across by `state_dict_from_jax`."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from romp_tpu.models import layers as jlayers
from romp_tpu.models.romp import init_romp_params, romp_forward
from romp_tpu.ops.centermap import parse_centermap2d as jax_parse
from romp_tpu.ops.centermap import sample_maps_at as jax_sample
from romp_tpu.ops import projection as jproj
from romp_tpu.pipeline import romp_pipeline as jpipe
from romp_tpu.smpl.assets import synthetic_assets
from romp_tpu.smpl.body_model import SmplModel as JaxSmpl
from romp_tpu_torch.models.layers import (
    BasicBlock, Conv2d, LayerOpts, batch_norm, cast_bf16,
)
from romp_tpu_torch.models.romp import RompNet, calibrate_batchnorm
from romp_tpu_torch.ops.centermap import parse_centermap2d, sample_maps_at
from romp_tpu_torch.ops import projection as tproj
from romp_tpu_torch.pipeline.romp_pipeline import (
    RompConfig, RompPipeline, compact_slots, project_to_org_image,
    unpack_params,
)
from romp_tpu_torch.smpl.body_model import SmplModel
from romp_tpu_torch.utils.checkpoint import state_dict_from_jax

torch.set_num_threads(2)
SIZE = 64
TINY = "hrnet32_tiny"
MIXED = LayerOpts(compute_dtype=torch.bfloat16)
BF16_ACT = LayerOpts(compute_dtype=torch.bfloat16, act_dtype=torch.bfloat16)


def _rel(a, b):
    """max |a - b| / max |b|, and the mean of the same ratio."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    d = np.abs(a - b) / np.abs(b).max()
    return float(d.max()), float(d.mean())


@pytest.fixture(scope="module")
def tiny():
    """JAX params, the bridged port net, one image batch, JAX f32 maps."""
    jp = init_romp_params(jax.random.PRNGKey(0), input_size=SIZE,
                          backbone=TINY)
    sd = state_dict_from_jax({k: np.asarray(v) for k, v in jp.items()})
    net = RompNet(TINY)
    net.load_state_dict(sd, strict=True)
    net.eval()
    image = np.random.RandomState(0).rand(2, SIZE, SIZE, 3).astype(
        np.float32) * 255.0
    jmaps = romp_forward(jlayers.ParamStore(jp), jnp.asarray(image),
                         backbone=TINY)
    return dict(jp=jp, sd=sd, net=net, image=image,
                jmaps=[np.asarray(m) for m in jmaps])


def test_state_dict_keys_are_the_jax_keys(tiny):
    ours = {k: tuple(v.shape) for k, v in tiny["net"].state_dict().items()
            if not k.endswith("num_batches_tracked")}
    assert set(ours) == set(tiny["jp"])
    for k, v in tiny["jp"].items():
        shape = v.shape if v.ndim != 4 else (v.shape[3], v.shape[2], *v.shape[:2])
        assert ours[k] == tuple(shape), k


def test_tiny_maps_f32_match_jax(tiny):
    with torch.inference_mode():
        maps = tiny["net"](torch.from_numpy(tiny["image"]))
    assert maps[0].shape == (2, 8, 8, 1) and maps[1].shape == (2, 8, 8, 145)
    for ours, ref in zip(maps, tiny["jmaps"]):
        assert _rel(ours.numpy(), ref)[0] <= 1e-4


@pytest.mark.parametrize("cin,cout,k,stride,bias", [
    (3, 64, 3, 2, False), (64, 64, 1, 1, False), (64, 64, 3, 1, False),
    (32, 64, 3, 2, False), (34, 64, 3, 2, True), (64, 145, 1, 1, True)])
def test_mixed_conv_matches_jax(cin, cout, k, stride, bias):
    """The mixed-path conv is the JAX one: bf16 operands, exact products,
    f32 sums and output (layers.py:125-130), within f32 summation order."""
    rng = np.random.RandomState(cin + cout + k)
    x = rng.randn(2, 16, 16, cin).astype(np.float32)
    params = {"c.weight": jnp.asarray(
        rng.randn(k, k, cin, cout).astype(np.float32) * 0.1)}
    if bias:
        params["c.bias"] = jnp.asarray(rng.randn(cout).astype(np.float32))
    ref = np.asarray(jlayers.conv2d(
        jlayers.ParamStore(params, compute_dtype=jnp.bfloat16), "c",
        jnp.asarray(x), cout, k, stride, bias=bias))
    conv = Conv2d(cin, cout, k, stride, bias=bias)
    conv.load_state_dict({n[2:]: v for n, v in state_dict_from_jax(
        {n: np.asarray(v) for n, v in params.items()}).items()})
    with torch.inference_mode():
        tx = torch.from_numpy(x).permute(0, 3, 1, 2)
        ours = conv(tx, MIXED).permute(0, 2, 3, 1).numpy()
        plain_f32 = conv(tx).permute(0, 2, 3, 1).numpy()
    assert _rel(ours, ref)[0] <= 1e-5
    assert _rel(plain_f32, ref)[0] > 1e-4     # the rounding really happens


def test_tiny_maps_mixed_match_jax(tiny):
    """compute_dtype=bfloat16, act_dtype=float32, whole network.

    Every conv must run as the mixed conv (a hook on each checks the opts
    it got), and each matches JAX's to f32 summation order (test above).
    But each conv rounds its input to bf16, and a value within that
    summation noise of a bf16 rounding boundary rounds the other way; the
    next layers spread each such step, so the whole net cannot meet a bar
    far below the bf16 noise itself. What it must show is that it computes
    the mixed function and not the f32 one: on BN-calibrated weights (maps
    of a trained net's scale) the port's mixed maps lie within half of the
    distance between JAX's mixed and f32 maps of JAX's mixed maps. Measured
    here: 3.1e-2 / 4.7e-2 max and 8.7e-3 / 4.6e-3 mean of max|map| (center,
    params), against 1.4e-1 / 1.3e-1 and 3.4e-2 / 1.8e-2 for JAX f32.
    """
    net = RompNet(TINY)
    net.load_state_dict(tiny["sd"], strict=True)
    calibrate_batchnorm(net, torch.from_numpy(np.random.RandomState(9).rand(
        4, SIZE, SIZE, 3).astype(np.float32) * 255.0))
    sd = net.state_dict()
    jp = {k: jnp.asarray(sd[k].numpy())
          if k.endswith(("running_mean", "running_var")) else v
          for k, v in tiny["jp"].items()}
    image = jnp.asarray(tiny["image"])
    jf32 = romp_forward(jlayers.ParamStore(jp), image, backbone=TINY)
    jmixed = romp_forward(
        jlayers.ParamStore(jp, compute_dtype=jnp.bfloat16,
                           act_dtype=jnp.float32), image, backbone=TINY)
    convs = [m for m in net.modules() if isinstance(m, Conv2d)]
    seen = []
    hooks = [m.register_forward_pre_hook(lambda m, args: seen.append(
        len(args) > 1 and args[1].compute_dtype == torch.bfloat16))
        for m in convs]
    with torch.inference_mode():
        maps = net(torch.from_numpy(tiny["image"]), MIXED)
    for h in hooks:
        h.remove()
    assert len(seen) == len(convs) and all(seen)
    for ours, ref, f32 in zip(maps, jmixed, jf32):
        mx, mean = _rel(ours.numpy(), np.asarray(ref))
        gap_mx, gap_mean = _rel(np.asarray(f32), np.asarray(ref))
        assert mx <= 0.5 * gap_mx and mean <= 0.5 * gap_mean, (
            mx, mean, gap_mx, gap_mean)


def test_parse_centermap_matches_jax():
    rng = np.random.RandomState(4)
    cm = rng.rand(2, 64, 64).astype(np.float32)
    thresh = 0.999
    jd = jax_parse(jnp.asarray(cm), max_person=64, conf_thresh=thresh)
    td = parse_centermap2d(torch.from_numpy(cm), max_person=64,
                           conf_thresh=thresh)
    jmask, tmask = np.asarray(jd.mask), td.mask.numpy()
    assert jmask.sum() > 0
    for b in range(2):
        jset = dict(zip(np.asarray(jd.flat_inds)[b][jmask[b]].tolist(),
                        np.asarray(jd.scores)[b][jmask[b]].tolist()))
        tset = dict(zip(td.flat_inds[b][tmask[b]].tolist(),
                        td.scores[b][tmask[b]].tolist()))
        assert jset == tset
    valid = tmask
    np.testing.assert_array_equal(
        td.yx.numpy()[valid],
        np.stack([td.flat_inds.numpy() // 64, td.flat_inds.numpy() % 64],
                 -1)[valid])


def test_sample_maps_matches_jax():
    rng = np.random.RandomState(5)
    maps = rng.randn(2, 8, 8, 145).astype(np.float32)
    inds = np.array([[5, 63, 0], [12, 7, 70]], np.int32)   # 70: clipped
    np.testing.assert_array_equal(
        sample_maps_at(torch.from_numpy(maps), torch.from_numpy(inds)).numpy(),
        np.asarray(jax_sample(jnp.asarray(maps), jnp.asarray(inds))))


def test_unpack_params_matches_jax():
    raw = np.random.RandomState(6).randn(3, 5, 145).astype(np.float32)
    ours = unpack_params(torch.from_numpy(raw), 1.1)
    ref = jpipe.unpack_params(jnp.asarray(raw), 1.1)
    for k in ("cam", "smpl_thetas", "smpl_betas"):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-5)


def test_estimate_translation_matches_jax_with_invalid_rows():
    rng = np.random.RandomState(7)
    B, N = 5, 24
    j3d = rng.randn(B, N, 3).astype(np.float32)
    j3d[..., 2] += 5.0
    pj2d = rng.rand(B, N, 2).astype(np.float32) * 512.0
    w = np.ones((B, N), np.float32)
    w[0] = 0.0              # invalid: no points
    w[1, 3:] = 0.0          # invalid: 3 < 4 points
    w[2, :10] = 0.0         # valid with 14 points
    ours = tproj.estimate_translation_lstsq(
        torch.from_numpy(j3d), torch.from_numpy(pj2d), torch.from_numpy(w))
    ref = np.asarray(jproj.estimate_translation_lstsq(
        jnp.asarray(j3d), jnp.asarray(pj2d), jnp.asarray(w)))
    np.testing.assert_allclose(ours[:2].numpy(), -1.0)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name,args", [
    ("weak_perspective_projection", ("points", "cam")),
    ("weak_perspective_projection_keep_dim", ("points", "cam")),
    ("convert_to_org_image_coords", ("kps2", "pad")),
    ("convert_to_org_image_coords", ("kps3", "pad")),
    ("convert_to_org_image_coords_np", ("kps3", "pad")),
    ("cam_to_3d_trans", ("cam",)),
])
def test_projection_helpers_match_jax(name, args):
    rng = np.random.RandomState(9)
    data = {"points": rng.randn(2, 5, 7, 3), "cam": rng.rand(2, 5, 3) + 0.5,
            "kps2": rng.rand(4, 7, 2) * 2 - 1, "kps3": rng.rand(4, 7, 3) * 2 - 1,
            "pad": np.array([10, 90, 0, 120, 80, 120])}
    inputs = [data[a].astype(np.float32) for a in args]
    kw = {}
    if name.endswith("_keep_dim"):
        name, kw = name[:-len("_keep_dim")], {"keep_dim": True}
    if name.endswith("_np"):
        ours = getattr(tproj, name)(*inputs)
    else:
        ours = getattr(tproj, name)(*map(torch.from_numpy, inputs), **kw).numpy()
    ref = np.asarray(getattr(jproj, name)(*map(jnp.asarray, inputs), **kw))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-5)


def test_project_to_org_image_matches_jax():
    rng = np.random.RandomState(10)
    out = {"pj2d": rng.rand(3, 71, 2).astype(np.float32) * 2 - 1,
           "verts_camed": rng.rand(3, 50, 3).astype(np.float32) * 2 - 1}
    pad = np.array([0, 300, 40, 440, 300, 400], np.float32)
    ours = project_to_org_image({k: torch.from_numpy(v) for k, v in out.items()},
                                torch.from_numpy(pad))
    ref = jpipe.project_to_org_image({k: jnp.asarray(v) for k, v in out.items()},
                                     jnp.asarray(pad))
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-4)


def test_compact_slots_matches_jax():
    rng = np.random.RandomState(8)
    B, K, n = 2, 8, 3
    mask = np.zeros((B, K), bool)
    mask[0, [1, 6]] = True
    mask[1, [0, 2, 4, 7]] = True
    confs = rng.rand(B, K).astype(np.float32)
    confs[1, 2] = confs[1, 4]                 # a tie: stable order decides
    verts = rng.randn(B, K, 10, 3).astype(np.float32)
    ours = compact_slots({"mask": torch.from_numpy(mask),
                          "center_confs": torch.from_numpy(confs),
                          "verts": torch.from_numpy(verts)}, n)
    ref = jpipe.compact_slots({"mask": jnp.asarray(mask),
                               "center_confs": jnp.asarray(confs),
                               "verts": jnp.asarray(verts)}, n)
    for k in ("mask", "center_confs", "verts"):
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]))


def test_romp_config_refuses_settings_not_ported():
    """resnet50 is not ported yet. bf16 activations are (act_dtype
    bfloat16), but only with bf16 conv operands: JAX's conv refuses a bf16
    result of f32 operands, and so does the port."""
    with pytest.raises(NotImplementedError):
        RompConfig(backbone="resnet50")
    with pytest.raises(ValueError, match="compute_dtype"):
        RompConfig(compute_dtype="float32", act_dtype="bfloat16")
    with pytest.raises(TypeError, match="preferred_element_type"):
        jlayers.conv2d(jlayers.ParamStore(
            {"c.weight": jnp.ones((1, 1, 2, 2))}, act_dtype=jnp.bfloat16),
            "c", jnp.ones((1, 4, 4, 2)), 2, 1)
    assert RompConfig(compute_dtype="bfloat16",
                      act_dtype="bfloat16").opts == BF16_ACT


def test_romp_inference_matches_jax(tiny):
    """Whole pipeline (f32): detections compared as sets of flat indices
    (top-k tie order may differ), then each valid person's parameters and
    mesh."""
    # He-normal init with untrained BN leaves the heads' outputs in the
    # hundreds (cam scale 1.1**s overflows); shrink the last 1x1 conv of the
    # params and cam heads, in both packages' weights, to the scale trained
    # weights give, so that the absolute bars below mean something
    jp = dict(tiny["jp"])
    for key in ("final_layers.1.2.weight", "final_layers.1.2.bias",
                "final_layers.3.2.weight", "final_layers.3.2.bias"):
        jp[key] = jp[key] * 0.01
    sd = state_dict_from_jax({k: np.asarray(v) for k, v in jp.items()})
    center = tiny["jmaps"][0]         # the center head is unchanged
    vals = np.sort(center.reshape(-1))[::-1]
    thresh = float(0.5 * (vals[12] + vals[13]))       # as test_pipeline.py:149
    assets = synthetic_assets(seed=0)
    cfg_kw = dict(input_size=SIZE, max_person=16, conf_thresh=thresh,
                  backbone=TINY)
    jcfg = jpipe.RompConfig(**cfg_kw)
    jsmpl = JaxSmpl.from_assets(assets)
    jout = jax.jit(lambda p, im: jpipe.romp_inference(p, jsmpl, im, jcfg))(
        jp, jnp.asarray(tiny["image"]))
    pipe = RompPipeline(sd, SmplModel(assets), RompConfig(**cfg_kw), "cpu")
    tout = pipe(tiny["image"])
    assert tout["verts"].shape == (2, 16, 6890, 3)
    assert tout["joints"].shape == (2, 16, 71, 3)
    jmask, tmask = np.asarray(jout["mask"]), tout["mask"].numpy()
    assert tmask.sum() > 0
    assert torch.isfinite(tout["cam_trans"]).all()
    for b in range(2):
        # a detection's center pixel identifies it on both sides
        jinds, tinds = np.asarray(jout["centers"])[b], tout["centers"].numpy()[b]
        jv = {tuple(c): s for c, s in zip(jinds[jmask[b]].tolist(),
                                           np.flatnonzero(jmask[b]))}
        tv = {tuple(c): s for c, s in zip(tinds[tmask[b]].tolist(),
                                           np.flatnonzero(tmask[b]))}
        assert set(jv) == set(tv)
        for c, ts in tv.items():
            for key in ("smpl_thetas", "smpl_betas", "cam", "verts"):
                np.testing.assert_allclose(
                    tout[key].numpy()[b, ts], np.asarray(jout[key])[b, jv[c]],
                    atol=1e-3, err_msg=key)


def _bn_params(rng, C, prefix):
    return {f"{prefix}.weight": (1 + 0.1 * rng.randn(C)).astype(np.float32),
            f"{prefix}.bias": (0.1 * rng.randn(C)).astype(np.float32),
            f"{prefix}.running_mean": (0.1 * rng.randn(C)).astype(np.float32),
            f"{prefix}.running_var": (1 + rng.rand(C)).astype(np.float32)}


def _bf16_close(ours, ref):
    """Single bf16 layers: bit-equal but at a few elements, where a conv
    sum within f32 summation noise of a bf16 rounding boundary rounds the
    other way (one step; BN and the shift may make it up to one step of
    max|ref|, 2^-7): at most 0.1% of the elements differ."""
    assert ours.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    ours, ref = ours.float().numpy(), np.asarray(ref.astype(jnp.float32))
    err = np.abs(ours - ref) / np.abs(ref).max()
    assert err.max() <= 2.0 ** -7 and (err > 0).mean() <= 1e-3, (
        err.max(), (err > 0).mean())


@pytest.mark.parametrize("cin,cout,k,stride,bias", [
    (3, 64, 3, 2, False), (64, 64, 3, 1, False), (34, 64, 3, 2, True),
    (64, 145, 1, 1, True)])
def test_bf16_act_conv_bn_relu_matches_jax(cin, cout, k, stride, bias):
    """act_dtype=bfloat16 (`layers.py:122-133, 164-168`): the conv's f32
    sum emitted in bf16, a bias added in bf16, BN folded in f32 and applied
    in bf16, ReLU; the port's layers on weights cast once by cast_bf16."""
    rng = np.random.RandomState(cin + cout + k)
    x = rng.randn(2, 16, 16, cin).astype(np.float32)
    params = {"c.weight": (rng.randn(k, k, cin, cout) * 0.1).astype(
        np.float32), **_bn_params(rng, cout, "bn")}
    if bias:
        params["c.bias"] = rng.randn(cout).astype(np.float32)
    store = jlayers.ParamStore({n: jnp.asarray(v) for n, v in params.items()},
                               compute_dtype=jnp.bfloat16,
                               act_dtype=jnp.bfloat16)
    ref = jax.nn.relu(jlayers.batch_norm(store, "bn", jlayers.conv2d(
        store, "c", jnp.asarray(x), cout, k, stride, bias=bias)))
    sd = state_dict_from_jax(params)
    conv, bn = Conv2d(cin, cout, k, stride, bias=bias), batch_norm(cout)
    conv.load_state_dict({n[2:]: v for n, v in sd.items()
                          if n.startswith("c.")})
    bn.load_state_dict({n[3:]: v for n, v in sd.items()
                        if n.startswith("bn.")})
    cast_bf16(conv), cast_bf16(bn.eval())
    with torch.inference_mode():
        ours = torch.relu(bn(conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                                  BF16_ACT))).permute(0, 2, 3, 1)
    _bf16_close(ours, ref)


@pytest.mark.parametrize("cin,planes,stride,downsample", [
    (64, 64, 1, False), (32, 64, 2, True)])
def test_bf16_act_basic_block_matches_jax(cin, planes, stride, downsample):
    """A BasicBlock under act_dtype=bfloat16: the residual add and ReLU in
    bf16 (`layers.py:180-192`)."""
    rng = np.random.RandomState(planes + stride)
    x = rng.randn(2, 16, 16, cin).astype(np.float32)
    params = {"b.conv1.weight": (rng.randn(3, 3, cin, planes) * 0.1).astype(
        np.float32), "b.conv2.weight": (rng.randn(3, 3, planes, planes)
                                        * 0.1).astype(np.float32),
        **_bn_params(rng, planes, "b.bn1"), **_bn_params(rng, planes, "b.bn2")}
    if downsample:
        params["b.downsample.0.weight"] = (
            rng.randn(1, 1, cin, planes) * 0.1).astype(np.float32)
        params.update(_bn_params(rng, planes, "b.downsample.1"))
    store = jlayers.ParamStore({n: jnp.asarray(v) for n, v in params.items()},
                               compute_dtype=jnp.bfloat16,
                               act_dtype=jnp.bfloat16)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = jlayers.basic_block(store, "b", xb, planes, stride, downsample)
    block = BasicBlock(cin, planes, stride, downsample).eval()
    block.load_state_dict({n[2:]: v for n, v in state_dict_from_jax(
        params).items()})
    cast_bf16(block)
    with torch.inference_mode():
        ours = block(torch.from_numpy(np.array(xb.astype(jnp.float32)))
                     .permute(0, 3, 1, 2).bfloat16(), BF16_ACT)
    _bf16_close(ours.permute(0, 2, 3, 1), ref)


@pytest.mark.parametrize("fuse", [False, True])
def test_tiny_maps_bf16_act_match_jax(tiny, fuse):
    """act_dtype=bfloat16, whole tiny network (unfused, and with the
    HRNet chains through the chain's plain twin, bf16 in and out). The
    single layers agree bit for bit but at rare rounding flips (tests
    above), and the random net spreads each flip, as on the mixed path. So,
    as there, the port's bf16 maps lie within half of JAX's own
    bf16-act-vs-f32 distance of JAX's bf16 maps (max and mean of
    max|map|). Measured: 0.30 / 0.23 of it unfused (center / params, max),
    0.33 / 0.28 fused. The maps come out bf16, as JAX's."""
    net = RompNet(TINY)
    net.load_state_dict(tiny["sd"], strict=True)
    calibrate_batchnorm(net, torch.from_numpy(np.random.RandomState(9).rand(
        4, SIZE, SIZE, 3).astype(np.float32) * 255.0))
    sd = net.state_dict()
    jp = {k: jnp.asarray(sd[k].numpy())
          if k.endswith(("running_mean", "running_var")) else v
          for k, v in tiny["jp"].items()}
    image = jnp.asarray(tiny["image"])
    jf32 = romp_forward(jlayers.ParamStore(jp), image, backbone=TINY)
    jbf16 = romp_forward(jlayers.ParamStore(
        jp, compute_dtype=jnp.bfloat16, act_dtype=jnp.bfloat16), image,
        backbone=TINY)
    cast_bf16(net)
    if fuse:
        net.pack_chains()
    opts = LayerOpts(compute_dtype=torch.bfloat16, act_dtype=torch.bfloat16,
                     fuse_chains=fuse)
    with torch.inference_mode():
        maps = net(torch.from_numpy(tiny["image"]), opts)
    for ours, ref, f32 in zip(maps, jbf16, jf32):
        assert ours.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
        ref = np.asarray(ref.astype(jnp.float32))
        mx, mean = _rel(ours.float().numpy(), ref)
        gap_mx, gap_mean = _rel(np.asarray(f32), ref)
        assert mx <= 0.5 * gap_mx and mean <= 0.5 * gap_mean, (
            mx, mean, gap_mx, gap_mean)


def test_romp_inference_bf16_act_on_cpu(tiny):
    """RompPipeline with act_dtype=bfloat16: the weights are cast once at
    load, the head maps widened to f32 before the parse (as JAX), and the
    outputs are finite, of the f32 pipeline's shapes and dtypes."""
    assets = synthetic_assets(seed=0)
    cfg_kw = dict(input_size=SIZE, max_person=4, conf_thresh=-1e9,
                  backbone=TINY, compute_dtype="bfloat16")
    outs = [RompPipeline(tiny["sd"], SmplModel(assets),
                         RompConfig(act_dtype=act, **cfg_kw), "cpu")(
                             tiny["image"])
            for act in ("float32", "bfloat16")]
    assert set(outs[0]) == set(outs[1])
    for k in outs[0]:
        assert outs[1][k].shape == outs[0][k].shape, k
        assert outs[1][k].dtype == outs[0][k].dtype, k
        assert torch.isfinite(outs[1][k].float()).all(), k
