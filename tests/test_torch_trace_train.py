"""Port parity for TRACE's train step: romp_tpu_torch.train.trace_train_step
vs romp_tpu.train.trace_train_step on the head at map size 16, 2 clips of 2
frames, 2 tracks (one track invalid in some frames), the same weights (the
port's seeded init in JAX's layouts) and the same numpy batch: the losses,
the per-clip BatchNorm updates, every gradient and the parameters after one
AdamW step, in f32 here and in f64 in a subprocess; the per-clip
recompute; the bridge from a JAX `trace_last.npz`."""
import os
import os.path as osp
import subprocess
import sys
import textwrap

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from romp_tpu.train import trace_train_step as jtts
from romp_tpu.train.trainer import save_train_state as jax_save_train_state
from romp_tpu_torch.models.layers import record_bn_updates
from romp_tpu_torch.models.trace import TraceNet, init_trace_params
from romp_tpu_torch.train import trace_train_step as ttts
from romp_tpu_torch.train.loss_merger import merge_losses
from romp_tpu_torch.train.trainer import _unflatten
from romp_tpu_torch.utils.checkpoint import (
    state_dict_from_jax, trace_train_state_from_jax,
)

torch.set_num_threads(2)
REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
MAP, CLIP, B, N = 16, 2, 2, 2
# JAX layouts of the port's conv kernels: OIL -> LIO, OIHW -> HWIO,
# OIDHW -> DHWIO (the inverse of `utils/checkpoint.py` _TO_TORCH)
_TO_JAX = {3: (2, 1, 0), 4: (2, 3, 1, 0), 5: (2, 3, 4, 1, 0)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def to_jax_layout(sd):
    """A port state dict -> JAX's flat dict (numpy, no counters)."""
    out = {}
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        a = v.numpy()
        if k.endswith(".weight") and a.ndim in _TO_JAX:
            a = a.transpose(*_TO_JAX[a.ndim])
        out[k] = a
    return out


def from_jax(d):
    """JAX's flat dict -> torch layouts, keeping the dtype (f64 here;
    `state_dict_from_jax` casts to f32)."""
    inv = {3: (2, 1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}
    out = {}
    for k, v in d.items():
        a = np.asarray(v)
        if k.endswith(".weight") and a.ndim in inv:
            a = a.transpose(*inv[a.ndim])
        out[k] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def port_params():
    return init_trace_params(torch.Generator().manual_seed(0),
                             map_size=MAP, backbone=None)


def make_batch(seed=0):
    """Two clips whose features differ in scale (so per-clip BatchNorm
    statistics differ from whole-batch ones), track 1 invalid in clip 0's
    second frame, one z bin past the depth range (clamped by the gathers,
    masked out of the GT map)."""
    rng = np.random.RandomState(seed)
    czyx = np.stack([rng.randint(0, 64, (B, N, CLIP)),
                     rng.randint(0, MAP, (B, N, CLIP)),
                     rng.randint(0, MAP, (B, N, CLIP))], -1).astype(np.int32)
    czyx[1, 0, 1, 0] = 70
    valid = np.ones((B, N, CLIP), bool)
    valid[0, 1, 1] = False
    fm = (rng.randn(B, CLIP + 1, MAP, MAP, 32) * 0.3).astype(np.float32)
    fm[1] *= 3.0
    return {
        "feature_maps": fm,
        "flows": rng.randn(B, CLIP, MAP, MAP, 2).astype(np.float32),
        "traj_czyx": czyx,
        "traj_valid": valid,
        "traj3d_gt": rng.randn(B, N, CLIP, 3).astype(np.float32),
        "world_trans_gt": rng.randn(B, N, CLIP, 3).astype(np.float32),
        "world_grot_gt": (rng.randn(B, N, CLIP, 3) * 0.5).astype(np.float32),
        "pose_gt": (rng.randn(B, N, CLIP, 66) * 0.3).astype(np.float32),
        "betas_gt": (rng.randn(B, N, CLIP, 11) * 0.5).astype(np.float32),
    }


def port_net(sd=None):
    net = TraceNet(None, MAP)
    net.load_state_dict(port_params() if sd is None else sd)
    return net


def port_grads(net, batch, cfg):
    """The port's losses, gradients (by name) and BatchNorm updates."""
    net.train()
    total, (bn, metrics) = ttts.trace_compute_losses(net, batch, cfg)
    params = dict(net.named_parameters())
    names = sorted(params)
    grads = torch.autograd.grad(total, [params[k] for k in names],
                                allow_unused=True)
    return ({k: float(v.detach()) for k, v in metrics.items()},
            {k: g for k, g in zip(names, grads) if g is not None}, bn)


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_f32():
    """JAX's losses, BatchNorm updates, gradients and the state after one
    step (f32), from the port's init in JAX's layouts."""
    cfg = jtts.TraceTrainConfig()
    jp = {k: jnp.asarray(v) for k, v in to_jax_layout(port_params()).items()}
    state = jtts.trace_init_train_state(jp, cfg)
    batch = {k: jnp.asarray(v) for k, v in make_batch().items()}
    (_, (bn, metrics)), grads = jax.jit(
        lambda a, b, c: jax.value_and_grad(
            jtts.trace_compute_losses, has_aux=True)(a, b, c, cfg))(
        state.trainable, state.bn_state, batch)
    updates, opt_state = jtts._optimizer(cfg).update(
        grads, state.opt_state, state.trainable)
    after = jtts.TraceTrainState(
        optax.apply_updates(state.trainable, updates),
        {**state.bn_state, **bn}, opt_state, state.step + 1)
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                bn=bn, grads=grads, after=after)


def test_f32_losses_and_bn_updates_match_jax(jax_f32):
    """Losses within 1e-5 relative (measured 1.8e-6), and the BatchNorm
    updates, the per-clip statistics averaged over the clips, within 1e-5
    of max|ref| (measured 1.8e-6)."""
    metrics, _, bn = port_grads(port_net(), torch_batch(make_batch()),
                                ttts.TraceTrainConfig())
    assert set(metrics) == set(jax_f32["metrics"])
    for k, v in jax_f32["metrics"].items():
        assert abs(metrics[k] - v) <= 1e-5 * max(abs(v), 1e-3), (k, v)
    ref = state_dict_from_jax({k: np.asarray(v)
                               for k, v in jax_f32["bn"].items()})
    assert set(bn) == set(jax_f32["bn"])
    for k, v in bn.items():
        assert _rel(v.numpy(), ref[k].numpy()) <= 1e-5, k


def test_bn_updates_are_the_mean_of_per_clip_updates():
    """Each clip's BatchNorm normalizes over its own frames (JAX vmaps the
    clip over the batch): the two-clip update is the mean of the updates of
    each clip alone, and differs from one clip of all four frames."""
    batch = torch_batch(make_batch())
    cfg = ttts.TraceTrainConfig()
    _, _, both = port_grads(port_net(), batch, cfg)
    alone = [port_grads(port_net(), {k: v[b:b + 1] for k, v in batch.items()},
                        cfg)[2] for b in range(B)]
    key = "det_head.0.0.bn1.running_mean"
    assert key in both
    for k, v in both.items():
        mean = (alone[0][k] + alone[1][k]) / 2
        assert torch.allclose(v, mean, rtol=1e-6, atol=1e-7), k
    # one clip of both clips' frames: whole-batch statistics differ
    joined = {k: torch.cat([batch[k][0], batch[k][1]], dim=1)[None]
              for k in batch if k not in ("feature_maps", "flows")}
    joined["feature_maps"] = torch.cat(
        [batch["feature_maps"][0], batch["feature_maps"][1, 1:]])[None]
    joined["flows"] = torch.cat([batch["flows"][0], batch["flows"][1]])[None]
    _, _, whole = port_grads(port_net(), joined, cfg)
    assert _rel(whole[key].numpy(), both[key].numpy()) > 1e-2


def _f64_port_grads(monkeypatch, batch):
    """The port's step in float64 (`.float()` taken as `.double()`, as in
    `test_f64_trace_train_step_matches_jax`, which holds it to JAX's f64
    step within 1e-6): the reference for the f32 steps' own error."""
    monkeypatch.setattr(torch.Tensor, "float", torch.Tensor.double)
    net = port_net().double()
    tb = {k: v.double() if v.is_floating_point() else v
          for k, v in batch.items()}
    return port_grads(net, tb, ttts.TraceTrainConfig())[1]


def test_f32_grads_match_jax(jax_f32, monkeypatch):
    """Every gradient tensor in f32 against the f64 step, beside JAX's f32
    gradients against the same reference. A random head's f32 step is
    ill-conditioned (train-mode BatchNorm's backward over 2 frames
    subtracts nearly equal terms; ROADMAP queue 3): JAX's own f32 gradient
    of `center_map_refiner2.0.bn1.weight` is off the f64 one by 1.2 of its
    max, the port's by 7e-3, so the two f32 steps are not held to each
    other at their worst tensor. Bars, from the measured gaps (relative to
    each tensor's max|ref|): the port against f64, 1e-4 at the median
    tensor (measured 1.8e-5; JAX's 6.3e-6) and 5e-2 at the worst
    (measured 7.1e-3); the port against JAX's f32, 1e-4 at the median
    (measured 2.0e-5). Conv biases feeding a train-mode BatchNorm have an
    exactly-zero gradient: summation noise, 1e-5 of the largest
    gradient."""
    batch = torch_batch(make_batch())
    _, grads, _ = port_grads(port_net(), batch, ttts.TraceTrainConfig())
    ref64 = _f64_port_grads(monkeypatch, batch)
    monkeypatch.undo()
    ref = state_dict_from_jax({k: np.asarray(v)
                               for k, v in jax_f32["grads"].items()})
    gmax = max(float(v.abs().max()) for v in ref64.values())
    vs_f64, vs_jax = {}, {}
    for k, r in ref.items():
        if k.endswith("num_batches_tracked"):
            continue
        g = grads.get(k, torch.zeros_like(r))
        r64 = ref64.get(k, torch.zeros_like(r).double())
        if float(r64.abs().max()) <= 1e-6 * gmax:
            assert float(g.abs().max()) <= 1e-5 * gmax, k
            continue
        vs_f64[k] = _rel(g.numpy(), r64.numpy())
        vs_jax[k] = _rel(g.numpy(), r.numpy())
    assert len(vs_f64) > 100
    assert float(np.median(list(vs_f64.values()))) <= 1e-4, vs_f64
    assert max(vs_f64.values()) <= 5e-2, sorted(
        vs_f64.items(), key=lambda kv: kv[1])[-3:]
    assert float(np.median(list(vs_jax.values()))) <= 1e-4, vs_jax


def test_f32_step_is_optax_on_the_port_gradients():
    """One step in place (`trace_train_step`): the parameters equal optax's
    AdamW step (JAX's `_optimizer`) applied to the port's own gradients
    within 1e-7, a thousandth of the step (lr 1e-4; as ROMP's
    `test_optimizer_matches_optax`), plus two f32 ulps of the value (the
    BatchNorm weights sit near 1, where an ulp is 1.2e-7), the BatchNorm
    statistics take the
    clips' averaged updates, the counters advance. (Against JAX's f32
    gradients Adam's first step, about lr * sign(g) a weight, would show
    the conditioning above; the f64 step is held to JAX's whole step in
    `test_f64_trace_train_step_matches_jax`.)"""
    batch = torch_batch(make_batch())
    cfg = ttts.TraceTrainConfig()
    _, grads, bn = port_grads(port_net(), batch, cfg)
    params = {k: v.detach() for k, v in port_net().named_parameters()}
    opt = jtts._optimizer(jtts.TraceTrainConfig())
    jparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    jgrads = {k: jnp.asarray(grads.get(k, torch.zeros_like(v)).numpy())
              for k, v in params.items()}
    upd, _ = opt.update(jgrads, opt.init(jparams), jparams)
    ref = optax.apply_updates(jparams, upd)
    state = ttts.trace_init_train_state(port_net(), cfg)
    state, metrics = ttts.trace_train_step(state, batch, cfg)
    assert int(state.step) == 1 and int(state.opt_state.count) == 1
    assert np.isfinite(float(metrics["total"]))
    for k, v in state.trainable.items():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(ref[k]),
                                   rtol=2.4e-7, atol=1e-7, err_msg=k)
    for k, v in state.bn_state.items():
        assert torch.equal(v, bn[k]), k


def test_recomputed_clips_are_the_same_function():
    """Each clip runs as a checkpoint region and is recomputed in the
    backward: the losses, gradients and BatchNorm updates equal those of
    the clips run once without checkpointing (each recording its own
    updates, averaged, merged); the recompute records no second update,
    and neither it nor the forward touches the running statistics, and no
    BatchNorm is left recording after the backward."""
    batch = torch_batch(make_batch(1))
    cfg = ttts.TraceTrainConfig()
    net0 = port_net()
    m, grads, bn = port_grads(net0, batch, cfg)
    init = port_params()
    for k, v in net0.named_buffers():
        assert torch.equal(v, init[k]), k
    assert all(getattr(mod, "bn_updates", None) is None
               for mod in net0.modules())
    net = port_net().train()
    per_clip, updates = [], []
    try:
        for b in range(B):
            updates.append(record_bn_updates(net))
            per_clip.append(ttts._clip_losses(
                net, cfg, None, *(batch[k][b] for k in ttts.CLIP_KEYS)))
        total, ref_m = merge_losses(
            {k: torch.stack([c[k] for c in per_clip]).mean(0)
             for k in per_clip[0]}, cfg.loss_thresh)
        params = dict(net.named_parameters())
        ref_g = dict(zip(sorted(params), torch.autograd.grad(
            total, [params[k] for k in sorted(params)], allow_unused=True)))
    finally:
        record_bn_updates(net, on=False)
    assert m == {k: float(v.detach()) for k, v in ref_m.items()}
    assert set(grads) == {k for k, g in ref_g.items() if g is not None}
    for k, g in grads.items():
        assert torch.equal(g, ref_g[k]), k
    for k, v in bn.items():
        assert torch.equal(v, torch.stack([u[k] for u in updates]).mean(0)), k


def test_synthetic_batch_is_well_formed():
    b = ttts.make_trace_synthetic_batch(3, 2, 3, 4, MAP, "cpu")
    assert b["feature_maps"].shape == (2, 5, MAP, MAP, 32)
    assert b["flows"].shape == (2, 4, MAP, MAP, 2)
    assert b["traj_czyx"].shape == (2, 3, 4, 3)
    assert int(b["traj_czyx"][..., 0].max()) < 64
    assert int(b["traj_czyx"][..., 1:].max()) < MAP
    again = ttts.make_trace_synthetic_batch(3, 2, 3, 4, MAP, "cpu")
    assert all(torch.equal(b[k], again[k]) for k in b)


def test_trace_train_state_from_jax(tmp_path, jax_f32):
    """A JAX `trace_last.npz` (`save_train_state` of the state after one
    step) read into the port's TRACE train state: parameters, BatchNorm
    statistics, both moments, the optimizer's counters and the step."""
    path = str(tmp_path / "trace_last.npz")
    after = jax_f32["after"]
    jax_save_train_state(path, after)
    cfg = ttts.TraceTrainConfig()
    state = trace_train_state_from_jax(path, cfg, map_size=MAP)
    ref = state_dict_from_jax({k: np.asarray(v) for k, v in
                               {**after.trainable, **after.bn_state}.items()})
    for k, v in {**state.trainable, **state.bn_state}.items():
        assert torch.equal(v.detach(), ref[k]), k
    adam = next(s for s in jax.tree_util.tree_leaves(
        after.opt_state, is_leaf=lambda s: hasattr(s, "mu"))
        if hasattr(s, "mu"))
    for flat, jdict in ((state.opt_state.mu, adam.mu),
                        (state.opt_state.nu, adam.nu)):
        moments = state_dict_from_jax({k: np.asarray(v)
                                       for k, v in jdict.items()})
        for k, v in _unflatten(flat, state.trainable).items():
            assert torch.equal(v, moments[k]), k
    assert int(state.step) == 1 and int(state.opt_state.count) == 1
    assert int(state.opt_state.notfinite_count) == 0
    assert bool(state.opt_state.last_finite)


def test_f64_trace_train_step_matches_jax():
    """The same step in float64 on both sides (JAX with x64 on and its
    float32 taken as float64; the port's f64 net, whose casts and state
    follow its dtype): losses and BatchNorm updates within 1e-9, every gradient
    tensor and the parameters after the step within 1e-6 of max|ref|
    (measured 5.1e-12 at the worst gradient and 2.8e-10 at the worst
    parameter: the f32 gaps above are the step's conditioning). Weights
    whose gradient is summation noise on both sides (conv biases feeding a
    train-mode BatchNorm) are left out of the step's comparison: Adam's
    first step moves each by lr times the sign of that noise."""
    code = textwrap.dedent("""
        import sys
        import numpy as np, jax, optax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        import jax.numpy as jnp
        jnp.float32 = jnp.float64
        import torch
        torch.set_num_threads(2)
        sys.path.insert(0, "tests")
        from test_torch_trace_train import (
            from_jax, make_batch, port_grads, port_params, to_jax_layout,
            _rel)
        from romp_tpu.train import trace_train_step as jtts
        from romp_tpu_torch.models.trace import TraceNet
        from romp_tpu_torch.train import trace_train_step as ttts
        sd = {k: v.double() if v.is_floating_point() else v
              for k, v in port_params().items()}
        jp = {k: jnp.asarray(v, jnp.float64)
              for k, v in to_jax_layout(sd).items()}
        batch = make_batch()
        cfg = jtts.TraceTrainConfig()
        state = jtts.trace_init_train_state(jp, cfg)
        jb = {k: jnp.asarray(v.astype(np.float64) if v.dtype == np.float32
                             else v) for k, v in batch.items()}
        (_, (jbn, jm)), jg = jax.jit(lambda a, b, c: jax.value_and_grad(
            jtts.trace_compute_losses, has_aux=True)(a, b, c, cfg))(
            state.trainable, state.bn_state, jb)
        assert jax.tree_util.tree_leaves(jg)[0].dtype == jnp.float64
        upd, _ = jtts._optimizer(cfg).update(jg, state.opt_state,
                                             state.trainable)
        jafter = {**optax.apply_updates(state.trainable, upd),
                  **state.bn_state, **jbn}
        tb = {k: torch.from_numpy(v).double() if v.dtype == np.float32
              else torch.from_numpy(v) for k, v in batch.items()}
        net = TraceNet(None, 16)
        net.load_state_dict(sd)
        net = net.double()
        m, g, bn = port_grads(net, tb, ttts.TraceTrainConfig())
        for k, v in jm.items():
            assert abs(m[k] - float(v)) <= 1e-9 * max(abs(float(v)), 1e-3), k
        ref = from_jax(jg)
        gmax = max(float(np.abs(v.numpy()).max()) for v in ref.values())
        worst, zero = 0.0, set()
        for k, r in ref.items():
            got = g.get(k, torch.zeros_like(r))
            assert got.dtype == torch.float64, k
            if float(r.abs().max()) <= 1e-9 * gmax:
                assert float(got.abs().max()) <= 1e-9 * gmax, k
                zero.add(k)
                continue
            worst = max(worst, _rel(got.numpy(), r.numpy()))
        assert worst <= 1e-6, worst
        assert set(bn) == set(jbn)
        assert max(_rel(bn[k].numpy(), v.numpy())
                   for k, v in from_jax(jbn).items()) <= 1e-9
        net2 = TraceNet(None, 16)
        net2.load_state_dict(sd)
        st = ttts.trace_init_train_state(net2.double(),
                                         ttts.TraceTrainConfig())
        st, _ = ttts.trace_train_step(st, tb, ttts.TraceTrainConfig())
        ref = from_jax(jafter)
        # Adam's first step moves a weight by about lr * sign(g): where g is
        # summation noise (the zero gradients above) the signs are noise too
        step_worst = 0.0
        for k, v in {**st.trainable, **st.bn_state}.items():
            if k in zero:
                continue
            step_worst = max(step_worst, _rel(v.detach().numpy(),
                                              ref[k].numpy()))
        assert step_worst <= 1e-6, step_worst
        print("OK", worst, step_worst)
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().startswith("OK"), proc.stdout
    print(proc.stdout)
