"""Port parity for 2D-pose pretraining: romp_tpu_torch.train.{heatmap_ae,
pretrain} vs their romp_tpu counterparts, and the pretrain launcher on the
CPU.

Tolerances, each relative to the reference's max|.|:
- the heatmap GT, heatmap MSE and AE losses, values and gradients in f64:
  1e-12;
- the heatmap peak parse: equal indices, and exact coordinates on
  constructed peaks; the tag grouping: equal outputs;
- `PretrainNet`'s forward against `pretrain_forward` (HRNet-W32 at 64x64,
  batch 2, f32): 1e-4;
- `pretrain_losses` and its gradients in f64 (a subprocess: JAX with x64
  and its float32 taken as float64): 1e-9, held on fixed backbone features
  (a full-width f64 HRNet-W32 under JAX's grad compiles for minutes on the
  CPU), so the heads, the losses and their gradients are compared;
- the BatchNorm gate on a non-finite step: exact.
"""
import json
import os
import os.path as osp
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from romp_tpu.models.layers import ParamStore
from romp_tpu.train import heatmap_ae as jhae
from romp_tpu.train import pretrain as jpre
from romp_tpu.train.trainer import save_train_state as jax_save_train_state
from romp_tpu_torch.train import heatmap_ae as thae
from romp_tpu_torch.train import pretrain as tpre
from romp_tpu_torch.train.trainer import _unflatten
from romp_tpu_torch.utils.checkpoint import (
    pretrain_state_from_jax, state_dict_from_jax,
)

torch.set_num_threads(2)
REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
SIZE, B, P = 64, 2, 3


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def to_jax_layout(sd):
    """A port state dict -> JAX's flat dict (HWIO kernels, no counters)."""
    return {k: v.numpy().transpose(2, 3, 1, 0) if v.dim() == 4
            else v.numpy()
            for k, v in sd.items() if not k.endswith("num_batches_tracked")}


def from_jax(d):
    """JAX's flat dict -> torch layouts (OIHW), keeping the dtype."""
    return {k: torch.from_numpy(np.ascontiguousarray(
        np.asarray(v).transpose(3, 2, 0, 1) if np.ndim(v) == 4
        else np.asarray(v))) for k, v in d.items()}


def port_params():
    return tpre.init_pretrain_params(torch.Generator().manual_seed(0))


def make_batch(seed=0, size=SIZE):
    """A pretraining batch: 3 persons an image, person (1, 2) masked out,
    some joints unlabelled (-2), one joint outside the map."""
    rng = np.random.RandomState(seed)
    kp = rng.uniform(-0.9, 0.9, (B, P, 54, 2)).astype(np.float32)
    kp[:, :, 40:] = -2.0
    kp[0, 0, 3] = (1.2, 0.1)
    mask = np.ones((B, P), bool)
    mask[1, 2] = False
    return {
        "image": (rng.rand(B, size, size, 3) * 255).astype(np.float32),
        "kp2d_gt": kp,
        "person_centers": rng.uniform(-0.9, 0.9, (B, P, 2)).astype(
            np.float32),
        "person_bbox_hw": np.full((B, P, 2), 0.5, np.float32),
        "person_mask": mask,
    }


def _loss_case(seed=0, S=16, J=5):
    rng = np.random.RandomState(seed)
    kp = rng.uniform(-1.0, 1.0, (2, P, J, 2))
    kp[0, 1, 2] = -2.0
    vis = np.all(kp > -1.99, -1)
    vis[1, 0, 1] = False
    mask = np.ones((2, P), bool)
    mask[1, 2] = False
    vis &= mask[..., None]
    pred = rng.rand(2, S, S, J)
    tags = rng.randn(2, S, S, J)
    return kp, vis, mask, pred, tags, S


@pytest.mark.parametrize("name", ["joint_heatmaps", "heatmap_mse", "ae"])
def test_heatmap_ae_losses_match_jax_f64(name):
    """The heatmap GT (its gradient with respect to the keypoints), the
    channel-masked MSE and the AE pull / push (gradients with respect to
    the predictions) in f64 against JAX's (x64 on), to 1e-12 relative."""
    kp, vis, mask, pred, tags, S = _loss_case()
    ct = np.random.RandomState(1).randn(2, S, S, 5)
    with jax.enable_x64(True):
        if name == "joint_heatmaps":
            def jf(x):
                h = jhae.generate_joint_heatmaps(x, jnp.asarray(vis), S)
                return jnp.sum(h * ct), h
            x0 = kp
        elif name == "heatmap_mse":
            gt = np.asarray(jhae.generate_joint_heatmaps(
                jnp.asarray(kp), jnp.asarray(vis), S))

            def jf(x):
                v = jhae.heatmap_mse_loss(x, jnp.asarray(gt))
                return v, v
            x0 = pred
        else:
            def jf(x):
                pull, push = jhae.ae_loss(x, jnp.asarray(kp),
                                          jnp.asarray(vis),
                                          jnp.asarray(mask))
                return pull + 2.0 * push, jnp.stack([pull, push])
            x0 = tags
        (_, jout), jgrad = jax.value_and_grad(jf, has_aux=True)(
            jnp.asarray(x0))
        jout, jgrad = np.asarray(jout), np.asarray(jgrad)
    x = torch.tensor(x0, dtype=torch.float64, requires_grad=True)
    if name == "joint_heatmaps":
        out = thae.generate_joint_heatmaps(x, torch.from_numpy(vis), S)
        (out * torch.from_numpy(ct)).sum().backward()
    elif name == "heatmap_mse":
        out = thae.heatmap_mse_loss(x, torch.from_numpy(gt))
        out.backward()
    else:
        pull, push = thae.ae_loss(x, torch.from_numpy(kp),
                                  torch.from_numpy(vis),
                                  torch.from_numpy(mask))
        out = torch.stack([pull, push])
        (pull + 2.0 * push).backward()
    assert out.dtype == torch.float64
    assert np.abs(jout).max() > 0
    assert _rel(out.detach().numpy(), jout) <= 1e-12
    assert _rel(x.grad.numpy(), jgrad) <= 1e-12


def test_parse_joint_heatmaps_matches_jax():
    """On random maps the same cells, scores and tags, index for index
    (including the empty cells past the peaks, in `lax.top_k`'s order);
    on constructed peaks the exact coordinates."""
    rng = np.random.RandomState(2)
    heat = rng.rand(2, 12, 12, 4).astype(np.float32)
    tags = rng.randn(2, 12, 12, 4).astype(np.float32)
    for K in (4, 30):
        jc, js, jt, jv = (np.asarray(a) for a in jhae.parse_joint_heatmaps(
            jnp.asarray(heat), jnp.asarray(tags), K))
        tc, ts, tt, tv = (a.numpy() for a in thae.parse_joint_heatmaps(
            torch.from_numpy(heat), torch.from_numpy(tags), K))
        assert (js == 0).any() == (K == 30)
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(tv, jv)
    peaks = np.zeros((1, 32, 32, 2), np.float32)
    peaks[0, 5, 9, 0], peaks[0, 20, 30, 0], peaks[0, 31, 0, 1] = 0.9, 0.7, 1
    coords, scores, _, valid = thae.parse_joint_heatmaps(
        torch.from_numpy(peaks), torch.zeros(1, 32, 32, 2), 3)
    assert coords[0, 0, :2].tolist() == [[9.0, 5.0], [30.0, 20.0]]
    assert coords[0, 1, 0].tolist() == [0.0, 31.0]
    assert valid[0].sum(-1).tolist() == [2, 1]


def test_group_by_tags_matches_jax():
    """The port's copy of the host-side grouping: equal outputs on the same
    arrays (peaks of 3 persons over 4 joints, tags near 0, 2 and 4, some
    joints missing)."""
    rng = np.random.RandomState(5)
    J, K = 4, 5
    coords = rng.uniform(0, 32, (J, K, 2)).astype(np.float32)
    scores = rng.rand(J, K).astype(np.float32)
    tvals = (rng.randint(0, 3, (J, K)) * 2.0
             + rng.randn(J, K) * 0.1).astype(np.float32)
    valid = scores > 0.3
    got = thae.group_by_tags(coords, scores, tvals, valid)
    want = jhae.group_by_tags(coords, scores, tvals, valid)
    assert len(got) == len(want) >= 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_pretrain_forward_matches_jax():
    """`PretrainNet` against `pretrain_forward` (HRNet-W32 at 64x64, batch
    2, f32, running statistics): the heatmaps, tags and center map within
    1e-4 of max|ref| (measured 3.6e-6 to 4.0e-6); the state-dict keys are
    JAX's flat names."""
    sd = port_params()
    jp = {k: jnp.asarray(v) for k, v in to_jax_layout(sd).items()}
    cfg = jpre.PretrainConfig()
    shapes = jax.eval_shape(lambda: jpre.init_pretrain_params(
        jax.random.PRNGKey(0), cfg, input_size=SIZE))
    assert {k: v.shape for k, v in jp.items()} == {
        k: v.shape for k, v in shapes.items()}
    image = make_batch()["image"]
    ref = jax.jit(lambda p, x: jpre.pretrain_forward(ParamStore(p), x, cfg))(
        jp, jnp.asarray(image))
    net = tpre.PretrainNet()
    net.load_state_dict(sd)
    with torch.no_grad():
        out = net.eval()(torch.from_numpy(image))
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        assert _rel(o.numpy(), r) <= 1e-4


def test_f64_pretrain_losses_match_jax():
    """`pretrain_losses` in float64 on both sides (JAX with x64 on and its
    float32 taken as float64; the port with `.float()` taken as
    `.double()`), on fixed backbone features (JAX's `hrnet_w32` and the
    port's `PretrainNet.features` return the same seeded (2, 32, 16, 16)
    array), train mode: every loss and the total, each head gradient tensor
    and BatchNorm update, and after one `pretrain_step` the parameters and
    BatchNorm statistics, within 1e-9 of max|ref| (measured 6.3e-14 at the
    worst gradient, 8.7e-16 for the statistics, 9.7e-13 for the
    parameters after the step)."""
    code = textwrap.dedent("""
        import sys
        import numpy as np, jax, optax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        import jax.numpy as jnp
        jnp.float32 = jnp.float64
        import torch
        torch.Tensor.float = torch.Tensor.double
        torch.set_num_threads(2)
        sys.path.insert(0, ".")
        from tests.test_torch_pretrain import (
            from_jax, make_batch, port_params, to_jax_layout, _rel)
        import romp_tpu.models.hrnet as jhrnet
        from romp_tpu.train import pretrain as jpre
        from romp_tpu_torch.models.layers import record_bn_updates
        from romp_tpu_torch.train import pretrain as tpre
        feat = np.random.RandomState(7).randn(2, 16, 16, 32) * 0.7
        jhrnet.hrnet_w32 = lambda store, x, prefix: jnp.asarray(feat)
        sd = {k: v.double() if v.is_floating_point() else v
              for k, v in port_params().items()
              if not k.startswith("backbone.")}
        jp = {k: jnp.asarray(v, jnp.float64)
              for k, v in to_jax_layout(sd).items()}
        batch = make_batch(size=64)
        cfg = jpre.PretrainConfig()
        state = jpre.init_pretrain_state(jp, cfg)
        jb = {k: jnp.asarray(v.astype(np.float64) if v.dtype == np.float32
                             else v) for k, v in batch.items()}
        (_, (jbn, jm)), jg = jax.jit(lambda a, b, c: jax.value_and_grad(
            jpre.pretrain_losses, has_aux=True)(a, b, c, cfg))(
            state.trainable, state.bn_state, jb)
        assert jax.tree_util.tree_leaves(jg)[0].dtype == jnp.float64
        j1, _ = jax.jit(lambda s, b: jpre.pretrain_step(s, b, cfg))(state, jb)
        tfeat = torch.from_numpy(feat).permute(0, 3, 1, 2).contiguous()

        def port_net():
            net = tpre.PretrainNet()
            net.backbone = None
            net.load_state_dict(sd)
            net.features = lambda image, opts: tfeat
            return net.double().train()
        tb = {k: torch.from_numpy(v).double() if v.dtype == np.float32
              else torch.from_numpy(v) for k, v in batch.items()}
        net = port_net()
        updates = record_bn_updates(net)
        total, m = tpre.pretrain_losses(net, tb, tpre.PretrainConfig())
        record_bn_updates(net, on=False)
        names = sorted(k for k, _ in net.named_parameters())
        params = dict(net.named_parameters())
        grads = dict(zip(names, torch.autograd.grad(
            total, [params[k] for k in names])))
        assert sorted(m) == sorted(jm)
        for k, v in jm.items():
            assert abs(float(m[k].detach()) - float(v)) <= 1e-9 * abs(
                float(v)), (k, float(m[k]), float(v))
        ref = from_jax(jg)
        gmax = max(float(v.abs().max()) for v in ref.values())
        worst, zero = 0.0, set()
        assert sorted(ref) == names
        for k, r in ref.items():
            assert grads[k].dtype == torch.float64
            if float(r.abs().max()) <= 1e-9 * gmax:
                assert float(grads[k].abs().max()) <= 1e-9 * gmax, k
                zero.add(k)
                continue
            worst = max(worst, _rel(grads[k].numpy(), r.numpy()))
        assert worst <= 1e-9, worst
        assert sorted(updates) == sorted(jbn)
        bn_worst = max(_rel(updates[k].numpy(), v.numpy())
                       for k, v in from_jax(jbn).items())
        assert bn_worst <= 1e-9, bn_worst
        st = tpre.init_pretrain_state(port_net(), tpre.PretrainConfig())
        st, m1 = tpre.pretrain_step(st, tb, tpre.PretrainConfig())
        assert float(m1["grads_finite"]) == 1.0
        want = from_jax({**j1.trainable, **j1.bn_state})
        step_worst = max(_rel(v.detach().numpy(), want[k].numpy())
                         for k, v in st.trainable.items() if k not in zero)
        stat_worst = max(_rel(v.numpy(), want[k].numpy())
                         for k, v in st.bn_state.items())
        assert step_worst <= 1e-9 and stat_worst <= 1e-9, (step_worst,
                                                           stat_worst)
        print("OK", worst, bn_worst, step_worst, stat_worst)
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().startswith("OK"), proc.stdout
    print(proc.stdout)


def _tiny_pretrain_net():
    """A PretrainNet whose backbone is skipped: fixed seeded features, so
    the step tests run in a second on the CPU."""
    feat = torch.from_numpy(np.random.RandomState(7).randn(
        B, 32, SIZE // 4, SIZE // 4).astype(np.float32) * 0.7)
    net = tpre.PretrainNet()
    net.backbone = None
    net.load_state_dict({k: v for k, v in port_params().items()
                         if not k.startswith("backbone.")})
    net.features = lambda image, opts: feat + 0.0 * image.mean()
    return net


def test_nonfinite_step_gates_batchnorm():
    """A batch with a NaN pixel: the parameters, moments and BatchNorm
    statistics stay (JAX's pretrain_step gates the statistics on finite
    gradients, `pretrain.py:158-161`), `step` advances, grads_finite is 0;
    a finite step then moves them."""
    cfg = tpre.PretrainConfig()
    state = tpre.init_pretrain_state(_tiny_pretrain_net(), cfg)
    batch = {k: torch.from_numpy(v) for k, v in make_batch().items()}
    before = (state.flat.clone(), state.bn_flat.clone())
    nan = dict(batch, image=batch["image"].clone())
    nan["image"][0, 0, 0, 0] = float("nan")
    state, metrics = tpre.pretrain_step(state, nan, cfg)
    assert float(metrics["grads_finite"]) == 0.0
    assert torch.equal(state.flat, before[0])
    assert torch.equal(state.bn_flat, before[1])
    assert int(state.step) == 1 and int(state.opt_state.count) == 0
    state, metrics = tpre.pretrain_step(state, batch, cfg)
    assert float(metrics["grads_finite"]) == 1.0
    assert np.isfinite(float(metrics["total"]))
    assert sorted(metrics) == ["AE", "centermap", "grads_finite", "heatmap",
                               "total"]
    assert not torch.equal(state.flat, before[0])
    assert not torch.equal(state.bn_flat, before[1])


def test_pretrain_state_from_jax(tmp_path):
    """A JAX `pretrain_last.npz` (`save_train_state` of a PretrainState
    whose moments and counters were filled with seeded values) read into the
    port's: every JAX key lands, with its shape and value."""
    cfg = jpre.PretrainConfig()
    jp = {k: jnp.asarray(v) for k, v in to_jax_layout(port_params()).items()}
    state = jpre.init_pretrain_state(jp, cfg)
    rng = np.random.RandomState(4)
    leaves, tree = jax.tree_util.tree_flatten(state.opt_state)
    leaves = [jnp.asarray(rng.randn(*np.shape(x)).astype(np.float32))
              if np.asarray(x).dtype == np.float32 else
              jnp.asarray(np.full(np.shape(x), 3, np.asarray(x).dtype))
              if np.asarray(x).dtype == np.int32 else x for x in leaves]
    state = jpre.PretrainState(state.trainable, state.bn_state,
                               jax.tree_util.tree_unflatten(tree, leaves),
                               jnp.asarray(9, jnp.int32))
    path = str(tmp_path / "pretrain_last.npz")
    jax_save_train_state(path, state)
    st = pretrain_state_from_jax(path, tpre.PretrainConfig())
    want = state_dict_from_jax({k: np.asarray(v) for k, v in
                                {**state.trainable,
                                 **state.bn_state}.items()})
    got = {**st.trainable, **st.bn_state}
    assert sorted(got) == sorted(k for k in want
                                 if not k.endswith("num_batches_tracked"))
    for k, v in got.items():
        assert v.shape == want[k].shape and torch.equal(v.detach(),
                                                        want[k]), k
    adam = next(s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda s: hasattr(s, "mu"))
        if hasattr(s, "mu"))
    for flat, jdict in ((st.opt_state.mu, adam.mu),
                        (st.opt_state.nu, adam.nu)):
        moments = state_dict_from_jax({k: np.asarray(v)
                                       for k, v in jdict.items()})
        for k, v in _unflatten(flat, st.trainable).items():
            assert torch.equal(v, moments[k]), k
    assert int(st.step) == 9 and int(st.opt_state.count) == 3


def test_pretrain_launcher_on_cpu_and_fine_tune(tmp_path):
    """`pretrain.main` with --GPU -1 on a 2-image pack (HRNet-W32 at
    64x64, batch 2, f32): 2 steps logged to pretrain_log.jsonl with finite
    losses and grads_finite 1, and pretrain_last.npz written in the
    trainer's format; ROMP's Trainer then fine-tunes from it
    (`train.resume=... train.fine_tune=true`): the backbone and the center
    head come from the checkpoint, the params and cam heads keep their
    init, the pretraining head is left out."""
    import cv2

    from romp_tpu_torch.config import load_config
    from romp_tpu_torch.models.romp import init_romp_params
    from romp_tpu_torch.smpl.body_model import SmplModel, synthetic_assets
    from romp_tpu_torch.train.data.dataset import ImageAnnotation, save_pack
    from romp_tpu_torch.train.trainer import Trainer

    rng = np.random.RandomState(0)
    os.makedirs(tmp_path / "data")
    records = []
    for i in range(2):
        path = str(tmp_path / f"im{i}.jpg")
        cv2.imwrite(path, (rng.rand(80, 80, 3) * 255).astype(np.uint8))
        kp = rng.uniform(10, 70, (2, 54, 2)).astype(np.float32)
        kp[:, 30:] = -2.0
        records.append(ImageAnnotation(path, kp))
    save_pack(str(tmp_path / "data" / "coco.npz"), records)
    ck = tmp_path / "ck"
    args = ["--data_root", str(tmp_path / "data"), "--GPU", "-1",
            "--max_steps", "2", "model.input_size=64",
            "train.batch_size=2", "train.compute_dtype=float32",
            "train.log_every=1", f"train.checkpoint_dir={ck}",
            "data.datasets=coco"]
    assert tpre.main(args) == 0
    log = [json.loads(line) for line in
           (ck / "pretrain_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in log] == [1, 2]
    for r in log:
        assert r["grads_finite"] == 1.0
        assert all(np.isfinite(r[k]) for k in ("total", "heatmap", "AE",
                                                "centermap"))
    ckpt = str(ck / "pretrain_last.npz")
    with np.load(ckpt) as saved:
        assert int(saved["step"]) == 2
        pre = {k[3:]: saved[k] for k in saved.files if k.startswith("p::")}
    assert any(k.startswith("pretrain_head.") for k in pre)
    cfg = load_config(None, overrides=[
        "model.input_size=64", f"train.checkpoint_dir={tmp_path / 'ft'}",
        f"train.resume={ckpt}", "train.fine_tune=true",
        "train.tensorboard=false"])
    trainer = Trainer(cfg, SmplModel(synthetic_assets(seed=0)),
                      device="cpu")
    init = init_romp_params(torch.Generator().manual_seed(cfg.train.seed))
    got = trainer.state.trainable
    for k in ("backbone.conv1.weight", "final_layers.2.2.weight",
              "backbone.stage4.0.fuse_layers.0.1.0.weight"):
        np.testing.assert_array_equal(got[k].detach().numpy(), pre[k])
    for k in ("final_layers.1.2.weight", "final_layers.3.0.0.weight"):
        assert torch.equal(got[k].detach(), init[k])
    assert int(trainer.state.step) == 0
