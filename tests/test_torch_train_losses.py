"""Port parity for the training pieces below the step: skinning's gradient,
the losses, the loss merger, the GT center maps, train-mode BatchNorm, the
GMM prior and ResNet-50: romp_tpu_torch vs romp_tpu on the same numpy
inputs (CPU)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from romp_tpu.models import layers as jlayers
import romp_tpu.models.resnet  # noqa: F401  (its constants, made eagerly)
from romp_tpu.models.romp import romp_forward
from romp_tpu.ops.pallas_lbs import fused_skinning
from romp_tpu.train import centermap_gt as jgt
from romp_tpu.train import loss_merger as jmerge
from romp_tpu.train import losses as jlosses
from romp_tpu.train import priors as jpriors
from romp_tpu_torch.models.layers import (
    ConvTranspose2d, batch_norm, record_bn_updates,
)
from romp_tpu_torch.models.romp import RompNet
from romp_tpu_torch.models.romp import init_romp_params as tinit_romp_params
from romp_tpu_torch.ops.lbs import (
    skinning, skinning_backward, skinning_bwd_plain, skinning_plain,
)
from romp_tpu_torch.train import centermap_gt as tgt
from romp_tpu_torch.train import loss_merger as tmerge
from romp_tpu_torch.train import losses as tlosses
from romp_tpu_torch.train import priors as tpriors
from romp_tpu_torch.utils.checkpoint import state_dict_from_jax

torch.set_num_threads(2)
BAR = 1e-5          # of max|ref|: the losses and the GT maps


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


# --- skinning's gradient ---------------------------------------------------

def _skin(seed=0, B=3, V=500):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, 16, 24).astype(np.float32),
            np.abs(rng.randn(V, 24)).astype(np.float32),
            rng.randn(B, 3, V).astype(np.float32),
            rng.randn(B, 3, V).astype(np.float32))


def test_skinning_backward_matches_jax_vjp():
    """`skinning_bwd_plain`, the wrapper's CPU route and autograd of
    `skinning_plain` against `jax.vjp(fused_skinning)` (the custom_vjp's
    XLA backward): 1e-5 of max|ref|; the lbs weights get no gradient."""
    a16, w, vpos, g = _skin()
    _, vjp = jax.vjp(fused_skinning, *map(jnp.asarray, (a16, w, vpos)))
    ja, jw, jv = (np.asarray(x) for x in vjp(jnp.asarray(g)))
    assert not jw.any()
    ta, tw, tv, tg = _t(a16, w, vpos, g)
    da, dv = skinning_bwd_plain(ta, tw, tv, tg)
    assert _rel(da, ja) <= 1e-5 and _rel(dv, jv) <= 1e-5
    assert not da[:, 12:].any()
    assert _rel(skinning_backward(ta, tw, tv, tg)[0], ja) <= 1e-5
    for fn in (skinning, skinning_plain):
        a, v = ta.clone().requires_grad_(), tv.clone().requires_grad_()
        fn(a, tw, v).backward(tg)
        assert _rel(a.grad, ja) <= 1e-5 and _rel(v.grad, jv) <= 1e-5


def test_skinning_function_gradcheck_float64():
    """The autograd Function's CPU route (plain forward, plain backward)
    against finite differences, in float64."""
    a16, w, vpos, _ = _skin(seed=1, B=2, V=40)
    a = torch.from_numpy(a16).double().requires_grad_()
    v = torch.from_numpy(vpos).double().requires_grad_()
    tw = torch.from_numpy(w).double()
    assert torch.autograd.gradcheck(lambda a, v: skinning(a, tw, v), (a, v))


# --- the losses -----------------------------------------------------------

def _kp_inputs(seed, N=6, J=54):
    rng = np.random.RandomState(seed)
    gt = (rng.randn(N, J, 3) * 0.3).astype(np.float32)
    pred = (gt + rng.randn(N, J, 3) * 0.05).astype(np.float32)
    gt[0, 5:9] = -2.0                     # invalid joints
    gt[1, 3:] = -2.0                      # a degenerate person: 3 joints...
    gt[2, 2:] = -2.0                      # ...and 2 (dropped from PA-MPJPE)
    w = np.array([1, 1, 1, 0, 1, 1], np.float32)
    return gt, pred, w


@pytest.mark.parametrize("name", ["kp2d", "mpjpe", "pampjpe"])
def test_keypoint_loss_and_grad_match_jax(name):
    """Values and gradients (pred) at 1e-5 of max|ref|; PA-MPJPE with a
    degenerate person, whose gradient is exactly zero (the guard before the
    SVD), not NaN."""
    gt, pred, w = _kp_inputs(3)
    if name == "kp2d":
        gt, pred = gt[..., :2], pred[..., :2]
    if name == "pampjpe":
        gt, pred = gt[:, :24], pred[:, :24]
    jfn = {"kp2d": jlosses.kp2d_l2_loss, "mpjpe": jlosses.mpjpe_loss,
           "pampjpe": jlosses.pampjpe_loss}[name]
    tfn = {"kp2d": tlosses.kp2d_l2_loss, "mpjpe": tlosses.mpjpe_loss,
           "pampjpe": tlosses.pampjpe_loss}[name]
    jv, jg = jax.jit(jax.value_and_grad(lambda p: jfn(
        jnp.asarray(gt), p, jnp.asarray(w))))(jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_()
    tv = tfn(*_t(gt), tp, *_t(w))
    tv.backward()
    assert abs(float(tv.detach()) - float(jv)) <= BAR * abs(float(jv))
    assert np.isfinite(tp.grad.numpy()).all()
    assert _rel(tp.grad, jg) <= BAR
    if name == "pampjpe":
        assert not tp.grad[2].any()


def test_procrustes_align_matches_jax():
    gt, pred, _ = _kp_inputs(4)
    valid = (gt != -2.0).any(-1).astype(np.float32)
    ref = jlosses.procrustes_align(jnp.asarray(gt), jnp.asarray(pred),
                                   jnp.asarray(valid))
    ours = tlosses.procrustes_align(*_t(gt, pred, valid))
    assert _rel(ours[3:], np.asarray(ref)[3:]) <= BAR


def test_focal_pose_shape_losses_match_jax():
    rng = np.random.RandomState(5)
    pred = rng.uniform(-0.2, 1.2, (2, 16, 16)).astype(np.float32)
    gt = np.array(jgt.generate_centermap(
        jnp.asarray(rng.uniform(-0.9, 0.9, (2, 3, 2)).astype(np.float32)),
        jnp.full((2, 3), 2, jnp.int32), jnp.ones((2, 3), bool), 16))
    gt[1] = 0.0                                # an image without positives
    cases = [
        (jlosses.focal_heatmap_loss, tlosses.focal_heatmap_loss, (pred, gt),
         0),
        (jlosses.pose_l2_loss, tlosses.pose_l2_loss,
         ((rng.randn(5, 66) * 0.4).astype(np.float32),
          (rng.randn(5, 66) * 0.4).astype(np.float32),
          np.array([1, 0, 1, 1, 1], np.float32)), 1),
        (jlosses.shape_loss, tlosses.shape_loss,
         (rng.randn(5, 10).astype(np.float32),
          rng.randn(5, 10).astype(np.float32),
          np.ones(5, np.float32), np.array([1, 0, 1, 0, 1], np.float32)), 1),
    ]
    for jfn, tfn, args, arg in cases:
        jv, jg = jax.jit(jax.value_and_grad(
            lambda x: jfn(*[x if i == arg else jnp.asarray(a)
                            for i, a in enumerate(args)])))(
            jnp.asarray(args[arg]))
        ts = _t(*args)
        ts[arg].requires_grad_()
        tv = tfn(*ts)
        tv.backward()
        assert abs(float(tv.detach()) - float(jv)) <= BAR * abs(float(jv)), tfn
        assert _rel(ts[arg].grad, jg) <= BAR, tfn


def test_gmm_and_angle_priors_match_jax():
    """The synthetic GMM is the same numpy draw; the prior loss (with its
    below-5 zeroing) and the angle prior, values and gradients."""
    jp, tp = jpriors.GmmPrior.synthetic(seed=3), tpriors.GmmPrior.synthetic(
        seed=3)
    for a, b in ((tp.means, jp.means), (tp.precisions, jp.precisions),
                 (tp.nll_weights, jp.nll_weights)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rng = np.random.RandomState(6)
    pose = (rng.randn(6, 72) * np.array([2.5] * 3 + [0.8] * 3)[:, None]
            ).astype(np.float32)
    w = np.array([1, 1, 0, 1, 1, 1], np.float32)
    jnll = jpriors.gmm_prior_nll(jp, jnp.asarray(pose[:, 3:]))
    above = np.asarray(jnll) / 100 > 5
    assert above.any() and not above.all()      # both sides of the gate
    for jfn, tfn in (
            (lambda p: jpriors.gmm_prior_loss(jp, p[:, 3:], jnp.asarray(w)),
             lambda p: tpriors.gmm_prior_loss(tp, p[:, 3:], *_t(w))),
            (lambda p: jnp.sum(jpriors.angle_prior(p)),
             lambda p: torch.sum(tpriors.angle_prior(p)))):
        jv, jg = jax.jit(jax.value_and_grad(jfn))(jnp.asarray(pose))
        t = torch.from_numpy(pose).requires_grad_()
        tv = tfn(t)
        tv.backward()
        assert abs(float(tv.detach()) - float(jv)) <= BAR * abs(float(jv))
        assert _rel(t.grad, jg) <= BAR


def test_clamp_and_merge_losses_match_jax():
    """A NaN loss drops out, one above the threshold is scaled to it with
    its gradient scaled alike; det-only schedule; task sums."""
    vals = {"centermap": 3.0, "centermap3d": 2500.0, "kp2d": float("nan"),
            "mpjpe": 1200.0, "pose": 4.0, "rage": 1.5, "extra": 2.0}
    for new_training in (False, True):
        def jf(x):
            d = {k: x[i] for i, k in enumerate(vals)}
            return jmerge.merge_losses(d, 1000.0, new_training)
        x = np.array(list(vals.values()), np.float32)
        (jt, jm), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(x))
        tx = torch.from_numpy(x).requires_grad_()
        tt, tm = tmerge.merge_losses({k: tx[i] for i, k in enumerate(vals)},
                                     1000.0, new_training)
        tt.backward()
        assert sorted(tm) == sorted(jm)
        for k in jm:
            assert abs(float(tm[k]) - float(jm[k])) <= BAR * max(
                abs(float(jm[k])), 1.0), k
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg),
                                   rtol=BAR, atol=0)
    v = torch.tensor(2000.0, requires_grad=True)
    tmerge.clamp_loss(v, 1000.0).backward()
    assert float(v.grad) == pytest.approx(0.5)


# --- ground truth ---------------------------------------------------------

def test_centermap_gt_matches_jax():
    """person_radius, generate_centermap (with out-of-range and masked
    persons), collision_aware_centers and generate_centermap3d."""
    rng = np.random.RandomState(7)
    centers = rng.uniform(-0.95, 0.95, (2, 5, 2)).astype(np.float32)
    centers[0, 1] = centers[0, 0] + 0.02            # a colliding pair
    centers[1, 2] = [1.5, 0.0]                      # out of the map
    hw = rng.uniform(0.1, 1.5, (2, 5, 2)).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 1], [1, 1, 1, 1, 0]], bool)
    jr = jgt.person_radius(jnp.asarray(hw), 32)
    tr = tgt.person_radius(*_t(hw), 32)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    ref = jax.jit(jgt.generate_centermap, static_argnums=3)(
        jnp.asarray(centers), jr, jnp.asarray(mask), 32)
    ours = tgt.generate_centermap(*_t(centers), tr, *_t(mask), 32)
    assert _rel(ours, ref) <= BAR and (ours.numpy() == 1.0).sum() >= 6
    ref = jax.jit(jgt.collision_aware_centers, static_argnums=3)(
        jnp.asarray(centers), jr, jnp.asarray(mask), 32)
    ours = tgt.collision_aware_centers(*_t(centers), tr, *_t(mask), 32)
    assert _rel(ours, ref) <= BAR
    zyx = np.stack([rng.randint(-2, 18, (2, 4)), rng.randint(0, 20, (2, 4)),
                    rng.randint(0, 20, (2, 4))], -1)
    m3 = np.array([[1, 1, 0, 1], [1, 1, 1, 1]], bool)
    ref = jax.jit(jgt.generate_centermap3d, static_argnums=(2, 3))(
        jnp.asarray(zyx), jnp.asarray(m3), 20, 16)
    ours = tgt.generate_centermap3d(*_t(zyx, m3), 20, 16)
    assert _rel(ours, ref) <= BAR


# --- train-mode layers ----------------------------------------------------

def test_train_batchnorm_matches_jax_and_records_once():
    """Output, input gradient and the recorded running statistics against
    JAX's `batch_norm(train=True)`: 1e-5. The module's own buffers stay as
    they were; a second (recomputed) call records nothing new."""
    rng = np.random.RandomState(8)
    x = (rng.randn(3, 5, 6, 8) * 2 + 1).astype(np.float32)   # NHWC
    p = {"bn.weight": rng.rand(8).astype(np.float32) + 0.5,
         "bn.bias": rng.randn(8).astype(np.float32),
         "bn.running_mean": rng.randn(8).astype(np.float32),
         "bn.running_var": rng.rand(8).astype(np.float32) + 0.5}
    ct = rng.randn(*x.shape).astype(np.float32)

    def jf(xx):
        st = jlayers.ParamStore({k: jnp.asarray(v) for k, v in p.items()},
                                train=True)
        y = jlayers.batch_norm(st, "bn", xx)
        return jnp.sum(y * ct), (y, st.stats_updates)
    (_, (jy, ju)), jgx = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(x))
    bn = torch.nn.ModuleDict({"bn": batch_norm(8)})
    bn.load_state_dict(state_dict_from_jax(p))
    bn.train()
    before = bn.bn.running_mean.clone()
    updates = record_bn_updates(bn)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    ty = bn.bn(tx)
    first = {k: v.clone() for k, v in updates.items()}
    bn.bn(tx * 2)                               # recorded already: ignored
    (ty * torch.from_numpy(ct).permute(0, 3, 1, 2)).sum().backward()
    assert _rel(ty.permute(0, 2, 3, 1).detach(), jy) <= 1e-5
    assert _rel(tx.grad.permute(0, 2, 3, 1), jgx) <= 1e-5
    assert sorted(updates) == sorted(ju)
    for k in ju:
        assert _rel(updates[k], ju[k]) <= 1e-5
        assert torch.equal(updates[k], first[k])
    assert torch.equal(bn.bn.running_mean, before)
    record_bn_updates(bn, on=False)


@pytest.mark.parametrize("bias", [False, True])
def test_train_mode_mixed_conv_matches_jax(bias):
    """Train mode, compute_dtype=bfloat16: JAX's conv emits bf16 and then
    upcasts, the bias added after in f32 (`layers.py:110-120`); the port
    rounds the f32 conv's output to bf16 (each product of bf16 operands is
    exact, so both round the same f32 sums but at rare summation-order
    flips: one bf16 step, 2^-8 of max|ref|, at under 0.5% of the
    elements), and the values are not the inference conv's."""
    from romp_tpu_torch.models.layers import Conv2d, LayerOpts

    rng = np.random.RandomState(11)
    x = rng.randn(2, 12, 12, 16).astype(np.float32)
    params = {"c.weight": rng.randn(3, 3, 16, 24).astype(np.float32) * 0.1}
    if bias:
        params["c.bias"] = rng.randn(24).astype(np.float32)
    ref = np.asarray(jlayers.conv2d(jlayers.ParamStore(
        {k: jnp.asarray(v) for k, v in params.items()}, train=True,
        compute_dtype=jnp.bfloat16), "c", jnp.asarray(x), 24, 3, 1,
        bias=bias))
    conv = Conv2d(16, 24, 3, 1, bias=bias)
    conv.load_state_dict({k[2:]: v for k, v in state_dict_from_jax(
        params).items()})
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        ours = conv.train()(tx, LayerOpts(compute_dtype=torch.bfloat16))
        inference = conv.eval()(tx, LayerOpts(compute_dtype=torch.bfloat16))
    ours = ours.permute(0, 2, 3, 1).numpy()
    d = np.abs(ours - ref) / np.abs(ref).max()
    assert d.max() <= 2 ** -8 and (d > 1e-6).mean() <= 5e-3
    assert _rel(inference.permute(0, 2, 3, 1), ref) > 1e-4


def test_conv_transpose_layout_and_values_match_jax():
    """JAX stores the transposed conv's kernel HWOI; `state_dict_from_jax`
    carries it to torch's (I, O, kh, kw), and the outputs agree (f32, and
    on the mixed path, whose output JAX rounds to bf16)."""
    rng = np.random.RandomState(9)
    x = rng.randn(2, 6, 5, 12).astype(np.float32)
    st = jlayers.ParamStore(rng=jax.random.PRNGKey(1))
    jlayers.conv_transpose2d(st, "up", jnp.asarray(x), 7, 4, 2, 1)
    w = np.asarray(st.params["up.weight"])
    assert w.shape == (4, 4, 7, 12)
    sd = state_dict_from_jax({"up.weight": w})
    conv = ConvTranspose2d(12, 7, 4, 2, 1)
    conv.load_state_dict({"weight": sd["up.weight"]})
    assert tuple(conv.weight.shape) == (12, 7, 4, 4)
    from romp_tpu_torch.models.layers import LayerOpts
    for dt, opts in ((jnp.float32, LayerOpts()),
                     (jnp.bfloat16, LayerOpts(compute_dtype=torch.bfloat16))):
        ref = jlayers.conv_transpose2d(
            jlayers.ParamStore(st.params, compute_dtype=dt), "up",
            jnp.asarray(x), 7, 4, 2, 1)
        with torch.no_grad():
            ours = conv(torch.from_numpy(x).permute(0, 3, 1, 2), opts)
        assert ours.shape == (2, 7, 12, 10)
        # f32: summation order; mixed: both round to bf16, a flip is 2^-8
        bar = 1e-5 if dt == jnp.float32 else 2 ** -8
        assert _rel(ours.permute(0, 2, 3, 1), ref) <= bar


def test_resnet50_maps_match_jax():
    """RompNet(backbone="resnet50") against `romp_forward(backbone=
    "resnet50")` at 64x64, f32, on the port's seeded init carried to JAX's
    layouts (HWIO, and HWOI for the transposed convs): 1e-4 of max|ref|."""
    sd = tinit_romp_params(torch.Generator().manual_seed(2), "resnet50")
    jp = {k: jnp.asarray(v.numpy().transpose(2, 3, 1, 0) if v.dim() == 4
                         else v.numpy())
          for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    assert jp["backbone.deconv_layers.0.weight"].shape == (4, 4, 256, 2048)
    net = RompNet("resnet50")
    net.load_state_dict(state_dict_from_jax(jp), strict=True)
    image = np.random.RandomState(10).rand(2, 64, 64, 3).astype(
        np.float32) * 255
    ref = jax.jit(lambda p, x: romp_forward(
        jlayers.ParamStore(p), x, backbone="resnet50"))(jp, jnp.asarray(image))
    with torch.no_grad():
        ours = net.eval()(torch.from_numpy(image))
    for a, b in zip(ours, ref):
        assert a.shape == b.shape
        assert _rel(a, b) <= 1e-4


def test_romp_pipeline_and_cli_run_resnet50(tmp_path):
    """ResNet-50 inference through `RompPipeline` and the `romp` CLI
    (`--backbone resnet50`) on the CPU: finite outputs of the fixed shapes."""
    from romp_tpu_torch.cli.romp import main
    from romp_tpu_torch.pipeline.romp_pipeline import RompConfig, RompPipeline
    from romp_tpu_torch.smpl.body_model import SmplModel, synthetic_assets

    cfg = RompConfig(input_size=64, max_person=4, conf_thresh=-1e9,
                     backbone="resnet50")
    pipe = RompPipeline(tinit_romp_params(torch.Generator().manual_seed(0),
                                          "resnet50"),
                        SmplModel(synthetic_assets(seed=0)), cfg, "cpu")
    out = pipe(np.zeros((1, 64, 64, 3), np.uint8))
    assert out["verts"].shape == (1, 4, 6890, 3)
    assert all(torch.isfinite(v.float()).all() for v in out.values())
    import cv2
    image = str(tmp_path / "in.jpg")
    cv2.imwrite(image, (np.random.RandomState(0).rand(48, 64, 3) * 255
                        ).astype(np.uint8))
    main(["-m", "image", "-i", image, "-o", str(tmp_path / "out"), "--GPU",
          "-1", "--backbone", "resnet50", "--center_thresh=-1e9",
          "--max_person", "2", "--model_path", "", "--smpl_path", ""])
    assert list((tmp_path / "out").glob("*.npz"))
