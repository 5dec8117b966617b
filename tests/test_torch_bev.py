"""Port parity for BEV: romp_tpu_torch's BEV network, pipeline, crowd mode
and world view against romp_tpu's on the same numbers.

The JAX package's own init of the reduced-depth backbone (`hrnet32_tiny`)
at a 64x64 input (16x16 maps), carried across by `state_dict_from_jax`,
with BatchNorm statistics and biases set away from the identity; inputs
made with numpy from a seed. f32; bars are relative to max|ref|.
Detections are compared as sets of (z, y, x): `lax.top_k` and
`torch.topk` may order equal scores differently."""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from romp_tpu.models import bev as jbev
from romp_tpu.models.layers import ParamStore
from romp_tpu.ops.centermap import parse_centermap3d as jparse
from romp_tpu.pipeline import bev_pipeline as jbp
from romp_tpu.smpl.assets import synthetic_assets
from romp_tpu.smpl.body_model import SmplModel as JaxSmpl
from romp_tpu_torch.models import bev as tbev
from romp_tpu_torch.models.layers import cast_bf16
from romp_tpu_torch.ops.centermap import parse_centermap3d
from romp_tpu_torch.pipeline import bev_pipeline as tbp
from romp_tpu_torch.smpl.body_model import SmplModel
from romp_tpu_torch.utils.checkpoint import state_dict_from_jax

torch.set_num_threads(2)
SIZE = 64
TINY = "hrnet32_tiny"


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))


@pytest.fixture(scope="module")
def setup():
    jp = {k: np.asarray(v) for k, v in jbev.init_bev_params(
        jax.random.PRNGKey(0), input_size=SIZE, backbone=TINY).items()}
    rng = np.random.RandomState(5)
    for k in jp:
        if k.endswith("running_var"):
            jp[k] = (1.0 + rng.rand(*jp[k].shape)).astype(np.float32)
        elif k.endswith("running_mean"):
            jp[k] = (0.2 * rng.randn(*jp[k].shape)).astype(np.float32)
        elif k.endswith(".bias"):
            jp[k] = (0.05 * rng.randn(*jp[k].shape)).astype(np.float32)
    sd = state_dict_from_jax(jp)
    net = tbev.BevNet(TINY, SIZE // 4)
    net.load_state_dict(sd, strict=True)
    images = (np.random.RandomState(0).rand(2, SIZE, SIZE, 3) * 255).astype(
        np.float32)
    store = ParamStore({k: jnp.asarray(v) for k, v in jp.items()})
    anchors = jnp.asarray(jbev.cam3dmap_anchor())
    coord3d = jnp.asarray(jbev.coord_maps_3d_halfz(
        SIZE // 4, np.asarray(anchors)))
    jmaps = jax.jit(lambda x: jbev.bev_forward_maps(
        store, x, anchors, coord3d, backbone=TINY))(jnp.asarray(images))
    with torch.no_grad():
        tmaps = tbev.bev_forward_maps(net.eval(), torch.from_numpy(images))
    return dict(jp=jp, sd=sd, net=net, images=images, store=store,
                anchors=anchors, jmaps=jmaps, tmaps=tmaps,
                adult=synthetic_assets(seed=0, num_betas=11),
                baby=synthetic_assets(seed=1, num_betas=10))


def test_weight_bridge_finds_every_key_and_shape(setup):
    """JAX's seeded parameters through `state_dict_from_jax` carry every
    key and shape the port's BevNet expects (HWIO, LIO and DHWIO convs,
    Linear and Embedding weights); the port's own init has the same."""
    jp, net = setup["jp"], setup["net"]
    ours = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert {k for k in ours if not k.endswith("num_batches_tracked")} == set(jp)
    perm = {3: (2, 1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}
    for k, v in jp.items():
        shape = v.shape
        if k.endswith(".weight") and v.ndim in perm:
            shape = tuple(shape[i] for i in perm[v.ndim])
        assert ours[k] == tuple(shape), k
    assert ours["bv_out_layers.0.conv1.weight"] == (512, 20 * 16, 3)
    assert ours["cam_map_refiner.0.conv1.weight"] == (3, 3, 3, 3, 3)
    assert ours["transformer.0.weight"] == (512, 128)
    assert ours["position_embeddings.weight"] == (128, 128)
    init = tbev.init_bev_params(torch.Generator().manual_seed(0), SIZE, TINY)
    assert {k: tuple(v.shape) for k, v in init.items()} == ours


def test_anchor_and_coord_maps_match_jax():
    np.testing.assert_array_equal(tbev.cam3dmap_anchor(),
                                  jbev.cam3dmap_anchor())
    np.testing.assert_array_equal(
        tbev.coord_maps_3d_halfz(16, tbev.cam3dmap_anchor()),
        jbev.coord_maps_3d_halfz(16, jbev.cam3dmap_anchor()))


@pytest.mark.parametrize("field", list(tbev.BevMaps._fields))
def test_bev_forward_maps_match_jax(setup, field):
    """Each map within 1e-4 of max|ref|, f32 (measured: 3e-6 or less)."""
    ref = np.asarray(getattr(setup["jmaps"], field))
    ours = getattr(setup["tmaps"], field).numpy()
    assert ours.shape == ref.shape
    assert _rel(ours, ref) <= 1e-4


def _slots(zyx, mask):
    """{(b, z, y, x): slot} of the valid detections."""
    zyx = np.asarray(zyx).astype(int)
    mask = np.asarray(mask)
    return {(b, *zyx[b, k]): k for b in range(zyx.shape[0])
            for k in range(zyx.shape[1]) if mask[b, k]}


def test_detections_and_regressed_params_match_jax(setup):
    """The 3D parse's detections equal as sets; `bev_regress_params` at
    the matched slots within 1e-4 of max|ref| (f32)."""
    jdet = jparse(setup["jmaps"].center_maps_3d, 8, -1e9)
    tdet = parse_centermap3d(setup["tmaps"].center_maps_3d, 8, -1e9)
    js, ts = _slots(jdet.zyx, jdet.mask), _slots(tdet.zyx, tdet.mask)
    assert len(js) == 16 and set(js) == set(ts)
    jreg = np.asarray(jax.jit(lambda m, d: jbev.bev_regress_params(
        setup["store"], m, d, setup["anchors"]))(setup["jmaps"], jdet))
    with torch.no_grad():
        treg = tbev.bev_regress_params(setup["net"], setup["tmaps"],
                                       tdet).numpy()
    assert treg.shape == jreg.shape == (2, 8, 146)
    ref = np.stack([jreg[key[0], k] for key, k in js.items()])
    ours = np.stack([treg[key[0], ts[key]] for key in js])
    assert _rel(ours, ref) <= 1e-4


def test_depth_bin_ties_and_clamp_match_jax():
    """`cam_to_depth_bin` on scales between, on and beyond the anchors
    (argmin takes the lower index on a tie), as JAX's."""
    anchors = tbev.cam3dmap_anchor()
    mids = (anchors[:-1] + anchors[1:]) / 2.0
    scales = np.concatenate([anchors, mids, [-5.0, 0.0, 100.0]]).astype(
        np.float32)[None]
    ref = np.asarray(jbev.cam_to_depth_bin(jnp.asarray(scales),
                                           jnp.asarray(anchors)))
    ours = tbev.cam_to_depth_bin(torch.from_numpy(scales),
                                 torch.from_numpy(anchors)).numpy()
    np.testing.assert_array_equal(ours, ref)


def _pruning_inputs():
    """Three images of K = 6 slots: all valid with one near-duplicate pair
    and one far small outlier; two valid (the outlier pass is a no-op
    below three); four valid among masked rows."""
    rng = np.random.RandomState(8)
    B, K, J = 3, 6, 5
    pj2d = (rng.rand(B, K, J, 2) * 2 - 1).astype(np.float32)
    pj2d[0, 1] = pj2d[0, 0] + 1e-3
    scales = (0.5 + rng.rand(B, K)).astype(np.float32)
    scales[0, 5] = scales[1, 2] = 0.1
    trans = rng.randn(B, K, 3).astype(np.float32)
    trans[0, 5] = trans[1, 2] = [40.0, 40.0, 40.0]
    mask = np.ones((B, K), bool)
    mask[1, 2:] = False
    mask[2, [0, 3]] = False
    img_max_len = np.array([512.0, 640.0, 300.0], np.float32)
    return pj2d, scales, trans, mask, img_max_len


def test_pruning_masks_match_jax():
    """suppress_duplicates and remove_outliers, batched here and vmapped in
    JAX: the same masks, masked rows (the -inf of the row max) and the
    no-op below three people included."""
    pj2d, scales, trans, mask, L = _pruning_inputs()
    for nms in (0.5, 16.0):
        ref = np.asarray(jax.vmap(lambda p, s, m, n: jbp.suppress_duplicates(
            p, s, m, n, nms))(pj2d, scales, mask, L))
        ours = tbp.suppress_duplicates(
            torch.from_numpy(pj2d), torch.from_numpy(scales),
            torch.from_numpy(mask), torch.from_numpy(L), nms).numpy()
        np.testing.assert_array_equal(ours, ref)
    assert not ref.all()
    ref = np.asarray(jax.vmap(lambda t, s, m: jbp.remove_outliers(
        t, s, m, 3.0, 0.25))(trans, scales, mask))
    ours = tbp.remove_outliers(torch.from_numpy(trans),
                               torch.from_numpy(scales),
                               torch.from_numpy(mask), 3.0, 0.25).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert not ref[0, 5] and ref[1, 2] == mask[1, 2]


def test_bev_inference_matches_jax_end_to_end(setup):
    """`bev_inference` with synthetic SMPL-A and SMIL on both sides: the
    same detections (as sets) and pruned masks; every output at the
    matched slots within 1e-4 of max|ref| (f32). The perspective outputs
    (pj2d, verts_camed) divide by the point's depth, which random weights
    put near zero for some points (there the depth is the difference of
    two O(1) numbers, so f32 rounding of it is a large share of it), so
    they are held at the points 5 cm or more in front of the camera."""
    cfg_kw = dict(input_size=SIZE, max_person=8, conf_thresh=-1e9,
                  backbone=TINY, nms_thresh=0.5)
    jcfg = jbp.BevConfig(**cfg_kw)
    adult, baby = setup["adult"], setup["baby"]
    ja, jb = JaxSmpl.from_assets(adult), JaxSmpl.from_assets(baby)
    jparams = {k: jnp.asarray(v) for k, v in setup["jp"].items()}
    ref = jax.device_get(jax.jit(lambda p, im: jbp.bev_inference(
        p, ja, jb, im, jcfg))(jparams, jnp.asarray(setup["images"])))
    pipe = tbp.BevPipeline(setup["sd"], SmplModel(adult), SmplModel(baby),
                           tbp.BevConfig(**cfg_kw), device="cpu")
    out = {k: v.numpy() for k, v in pipe(setup["images"]).items()}
    assert set(out) == set(ref)
    js = _slots(ref["pred_czyxs"], np.ones((2, 8), bool))
    ts = _slots(out["pred_czyxs"], np.ones((2, 8), bool))
    assert len(js) == 16 and set(js) == set(ts)
    assert out["verts"].shape == (2, 8, 6890, 3)
    def matched(res, slots, k):
        return np.stack([res[k][key[0], s] for key, s in slots.items()])

    r_ = {k: matched(ref, js, k) for k in ref}
    o_ = {k: matched(out, {key: ts[key] for key in js}, k) for k in ref}
    depth = {p: (r_[p][..., 2] + r_["cam_trans"][:, None, 2] >= 0.05)
             for p in ("joints", "verts")}
    for k, r in r_.items():
        o = o_[k]
        if k in ("pj2d", "verts_camed"):
            keep = depth["joints" if k == "pj2d" else "verts"]
            assert keep.mean() > 0.5
            r, o = r[keep][:, :2], o[keep][:, :2]
        if r.dtype == bool or np.issubdtype(r.dtype, np.integer):
            np.testing.assert_array_equal(o, r, err_msg=k)
        else:
            assert _rel(o, r) <= 1e-4, (k, _rel(o, r))
    assert not out["mask"].all()        # the pruning removed someone


def test_bev_config_refuses_settings_not_ported():
    """resnet50 is not ported (BEV has none); bf16 activations are, with
    bf16 conv operands only, as in JAX (whose conv refuses a bf16 result
    of f32 operands)."""
    with pytest.raises(ValueError, match="compute_dtype"):
        tbp.BevConfig(act_dtype="bfloat16")
    with pytest.raises(NotImplementedError, match="backbone"):
        tbp.BevConfig(backbone="resnet50")
    assert tbp.BevConfig(compute_dtype="bfloat16",
                         act_dtype="bfloat16").opts.bf16_act


def test_bev_forward_maps_bf16_act_match_jax(setup):
    """act_dtype=bfloat16, the whole tiny net. Its layers agree with JAX's
    bit for bit but at rare rounding flips (the single-layer tests in
    test_torch_romp.py and test_torch_trace.py); a flip in the front-view
    head reaches every depth bin through the 1D convs' (C, H) fold, so
    each map is held to JAX's own bf16-act-vs-f32 distance: the mean
    difference within half of it, the largest within 1.5x of it
    (measured: the largest 1.01x for the 3D center map and 1.20x for the
    front-view one, the means 0.40-0.46x). JAX's dtypes are kept: every map is
    bf16 (the 3D cam map's refiner rounds the f32 coord-map sum back to
    bf16, `layers.py:329`)."""
    opts = tbp.BevConfig(compute_dtype="bfloat16", act_dtype="bfloat16").opts
    store = ParamStore({k: jnp.asarray(v) for k, v in setup["jp"].items()},
                       compute_dtype=jnp.bfloat16, act_dtype=jnp.bfloat16)
    coord3d = jnp.asarray(jbev.coord_maps_3d_halfz(
        SIZE // 4, np.asarray(setup["anchors"])))
    jbf16 = jax.jit(lambda x: jbev.bev_forward_maps(
        store, x, setup["anchors"], coord3d, backbone=TINY))(
            jnp.asarray(setup["images"]))
    net = tbev.BevNet(TINY, SIZE // 4)
    net.load_state_dict(setup["sd"], strict=True)
    cast_bf16(net.eval())
    with torch.no_grad():
        tbf16 = tbev.bev_forward_maps(net, torch.from_numpy(setup["images"]),
                                      opts)
    for field in tbev.BevMaps._fields:
        ref, ours = getattr(jbf16, field), getattr(tbf16, field)
        assert ours.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
        ref = np.asarray(ref.astype(jnp.float32))
        f32 = np.asarray(getattr(setup["jmaps"], field))
        d = np.abs(ours.float().numpy() - ref) / np.abs(ref).max()
        gap = np.abs(f32 - ref) / np.abs(ref).max()
        assert d.max() <= 1.5 * gap.max() and d.mean() <= 0.5 * gap.mean(), (
            field, d.max(), d.mean(), gap.max(), gap.mean())


def test_crowd_mode_matches_jax(setup):
    """`process_long_image` over a 3.25:1 panorama (five 64x64 windows in
    one batch), the port's BevPipeline against JAX's: the merged people
    and every merged output within 1e-4 of max|ref|."""
    from romp_tpu.pipeline.crowd import process_long_image as jlong
    from romp_tpu_torch.pipeline.crowd import process_long_image

    cfg_kw = dict(input_size=SIZE, max_person=4, conf_thresh=-1e9,
                  backbone=TINY)
    adult, baby = setup["adult"], setup["baby"]
    jpipe = jbp.BevPipeline(
        {k: jnp.asarray(v) for k, v in setup["jp"].items()},
        JaxSmpl.from_assets(adult), JaxSmpl.from_assets(baby),
        jbp.BevConfig(**cfg_kw))
    tpipe = tbp.BevPipeline(setup["sd"], SmplModel(adult), SmplModel(baby),
                            tbp.BevConfig(**cfg_kw), device="cpu")
    settings = types.SimpleNamespace(overlap_ratio=0.46, nms_thresh=1e-9,
                                     relative_scale_thresh=1e9,
                                     input_size=SIZE)
    image = np.random.RandomState(0).randint(0, 255, (40, 130, 3), np.uint8)
    ref = jlong(jpipe, image, settings)
    ours = process_long_image(tpipe, image, settings)
    assert ref is not None and ours is not None
    assert set(ours) == set(ref)
    assert ours["cam"].shape[0] == ref["cam"].shape[0] > 1
    # the merge reprojects pj2d with the full image's cams: held at the
    # joints 5 cm or more in front of the camera, as in the end-to-end
    # test; verts_camed is a window's, passed through unchanged (the
    # end-to-end test holds it)
    near = ref["joints"][..., 2] + ref["cam_trans"][:, None, 2] < 0.05
    assert near.mean() < 0.5
    for k, r in ref.items():
        o = np.asarray(ours[k])
        r = np.asarray(r)
        assert o.shape == r.shape, k
        if k == "verts_camed":
            continue
        if k == "pj2d":
            r, o = r[~near], o[~near]
        if r.dtype == bool or np.issubdtype(r.dtype, np.integer):
            np.testing.assert_array_equal(o, r, err_msg=k)
        else:
            assert _rel(o, r) <= 1e-4, (k, _rel(o, r))


def test_world_view_matches_jax(tmp_path):
    """`visualize_global_trajectory`, the port's copy against the JAX
    package's on the same tracks: the same files, the renders equal pixel
    for pixel and the HTML viewer equal."""
    cv2 = pytest.importorskip("cv2")
    from romp_tpu.vis.world_view import visualize_global_trajectory as jvis
    from romp_tpu_torch.vis.world_view import visualize_global_trajectory

    N, T = 2, 3
    rng = np.random.RandomState(0)
    outputs = {
        "track_ids": np.repeat([1, 2], T),
        "frame_ids": np.tile(np.arange(T), N),
        "frame_valid": np.ones(N * T, bool),
        "world_cams": rng.randn(N * T, 3),
        "verts": rng.randn(N * T, 3, 3) * 0.2,
    }
    faces = np.array([[0, 1, 2]], np.int32)
    ref = jvis(outputs, faces, str(tmp_path / "jax"), image_hw=(120, 160))
    ours = visualize_global_trajectory(outputs, faces, str(tmp_path / "port"),
                                       image_hw=(120, 160))
    assert len(ours) == len(ref) == T + 2
    for r, o in zip(ref, ours):
        assert o.split("/")[-1] == r.split("/")[-1]
        if o.endswith(".html"):
            assert open(o).read() == open(r).read()
        else:
            a, b = cv2.imread(o), cv2.imread(r)
            assert a is not None and (a != 255).any()
            np.testing.assert_array_equal(a, b)


def test_topdown_grid_is_bounded_for_far_tracks():
    """Tracks thousands of km out (the cams of untrained weights) draw a
    bounded grid: the JAX package's copy draws a line every metre and does
    not finish; within 50 m both draw the same (the test above)."""
    from romp_tpu_torch.vis.world_view import draw_trajectory_topdown

    far = {0: np.array([[1e7, 0.0, -3e6], [2e7, 0.0, 5e6]])}
    img = draw_trajectory_topdown(far, image_size=200)
    assert img.shape == (200, 200, 3) and (img != 255).any()
