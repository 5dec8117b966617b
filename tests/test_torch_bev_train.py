"""Port parity for BEV's train step and relative losses:
romp_tpu_torch.train.{bev_train_step, relative_losses} vs their
romp_tpu counterparts. The step runs on the tiny HRNet at 64x64 (16x16
maps x 64 depth bins), batch 2, 2 persons, SMPL+A from synthetic assets
(adult 11 betas, infant 10), the same weights (the port's seeded init in
JAX's layouts) and the same numpy batches.

Tolerances, each relative to the reference's max|.|:
- the relative losses, values and gradients in f64: 1e-12;
- the f64 step against JAX's (a subprocess: JAX with x64 and its float32
  taken as float64): every loss term, gradient tensor and BatchNorm update,
  1e-9 per tensor; the parameters, BatchNorm statistics and Adam moments
  after two steps, 1e-6 per tensor (Adam divides each gradient element by
  its own size, so an element near 0 carries its f64 noise into the step
  at full scale: see the test);
- the commit rule on a non-finite step: exact (parameters and moments
  unchanged, the statistics taken).
"""
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

from romp_tpu.train import bev_train_step as jbts
from romp_tpu.train import relative_losses as jrl
from romp_tpu.train.train_step import TrainConfig as JaxTrainConfig
from romp_tpu.train.trainer import save_train_state as jax_save_train_state
from romp_tpu_torch.models.bev import BevNet, init_bev_params
from romp_tpu_torch.smpl.body_model import SmplModel, synthetic_assets
from romp_tpu_torch.train import bev_train_step as tbts
from romp_tpu_torch.train import relative_losses as trl
from romp_tpu_torch.train import train_step as tts
from romp_tpu_torch.train.trainer import _unflatten
from romp_tpu_torch.utils.checkpoint import (
    bev_train_state_from_jax, state_dict_from_jax,
)

torch.set_num_threads(2)
REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
TINY, SIZE, B, P = "hrnet32_tiny", 64, 2, 2
# JAX layouts of the port's conv kernels: OIL -> LIO, OIHW -> HWIO,
# OIDHW -> DHWIO
_TO_JAX = {3: (2, 1, 0), 4: (2, 3, 1, 0), 5: (2, 3, 4, 1, 0)}
_TO_TORCH = {3: (2, 1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


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
    """JAX's flat dict -> torch layouts, keeping the dtype."""
    out = {}
    for k, v in d.items():
        a = np.asarray(v)
        if k.endswith(".weight") and a.ndim in _TO_TORCH:
            a = a.transpose(*_TO_TORCH[a.ndim])
        out[k] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def port_params():
    return init_bev_params(torch.Generator().manual_seed(0), SIZE, TINY)


def smpl_assets():
    return (synthetic_assets(seed=0, num_betas=11),
            synthetic_assets(seed=1, num_betas=10))


def make_batch(seed=0):
    """A BEV batch (ROMP's schema plus the relative annotations). Seed 0:
    image 0's persons share a depth layer (the tie branch), image 1's
    differ; person (0, 1) has the far scale 0.02, whose depth bin puts the
    predicted scale under the depth fence (checked in the test); kid
    offsets annotated for some. Seed 1: an unannotated depth layer, age
    and kid offset (-1), one person masked out."""
    rng = np.random.RandomState(seed)
    mask = np.ones((B, P), bool)
    scales = rng.uniform(0.2, 3.0, (B, P)).astype(np.float32)
    if seed == 0:
        scales[0, 1] = 0.02
        depth_ids = np.array([[1, 1], [0, 2]], np.int32)
        age_gts = np.array([[0, 3], [2, 1]], np.int32)
        kid = np.array([[0.1, 0.9], [-1.0, 0.6]], np.float32)
    else:
        mask[1, 1] = False
        depth_ids = np.array([[2, 0], [-1, 1]], np.int32)
        age_gts = np.array([[-1, 1], [3, 0]], np.int32)
        kid = np.array([[-1.0, 0.3], [0.95, -1.0]], np.float32)
    return {
        "image": (rng.rand(B, SIZE, SIZE, 3) * 255).astype(np.float32),
        "person_centers": rng.uniform(-0.9, 0.9, (B, P, 2)).astype(
            np.float32),
        "person_bbox_hw": np.full((B, P, 2), 0.5, np.float32),
        "person_mask": mask,
        "kp2d_gt": rng.uniform(-1, 1, (B, P, 54, 2)).astype(np.float32),
        "kp3d_gt": (rng.randn(B, P, 54, 3) * 0.3).astype(np.float32),
        "kp3d_mask": mask.copy(),
        "pose_gt": (rng.randn(B, P, 66) * 0.3).astype(np.float32),
        "pose_mask": mask.copy(),
        "betas_gt": np.concatenate(
            [rng.randn(B, P, 10) * 0.5, np.zeros((B, P, 1))], -1).astype(
                np.float32),
        "betas_mask": mask.copy(),
        "person_scales": scales,
        "depth_ids": depth_ids,
        "age_gts": age_gts,
        "kid_offsets_gt": kid,
    }


def port_config(**base):
    return tbts.BevTrainConfig(base=tts.TrainConfig(**base),
                               input_size=SIZE, backbone=TINY)


def port_net(sd=None):
    net = BevNet(TINY, SIZE // 4)
    net.load_state_dict(port_params() if sd is None else sd)
    return net


def torch_batch(batch, dtype=torch.float32):
    return {k: torch.from_numpy(v).to(dtype) if v.dtype == np.float32
            else torch.from_numpy(v) for k, v in batch.items()}


def _relative_case(seed=0):
    """Depths with ties and pairs on each side of the margin, one beyond
    the +-50 clip; ids with -1 and equal layers; a masked person."""
    rng = np.random.RandomState(seed)
    depths = rng.uniform(1.0, 8.0, (3, 5))
    depths[0, 1] = depths[0, 0]                 # a tie in depth
    depths[1, 4] = 90.0                         # beyond the clip
    ids = rng.randint(-1, 3, (3, 5)).astype(np.int32)
    ids[0, :2] = 1                              # a tie in layer
    mask = np.ones((3, 5), bool)
    mask[2, 3] = False
    kid = rng.uniform(-0.2, 1.2, (3, 5))
    kid[0, 0] = 0.25                            # on a bin edge
    ages = rng.randint(-1, 4, (3, 5)).astype(np.int32)
    kid_gt = np.where(rng.rand(3, 5) < 0.3, -1.0, rng.rand(3, 5))
    return depths, ids, mask, kid, ages, kid_gt


@pytest.mark.parametrize("name", ["relative_depth", "age_group",
                                  "kid_offset"])
def test_relative_loss_matches_jax_f64(name):
    """Each relative loss and its gradient in f64 against JAX's (x64 on),
    to 1e-12 relative."""
    depths, ids, mask, kid, ages, kid_gt = _relative_case()
    if name == "relative_depth":
        args, jfn, tfn = (depths, ids, mask), jrl.relative_depth_loss, \
            trl.relative_depth_loss
    elif name == "age_group":
        args, jfn, tfn = (kid, ages, mask), jrl.age_group_loss, \
            trl.age_group_loss
    else:
        args, jfn, tfn = (kid, kid_gt, mask), jrl.kid_offset_loss, \
            trl.kid_offset_loss
    with jax.enable_x64(True):
        jval, jgrad = jax.value_and_grad(jfn)(*(jnp.asarray(a)
                                                for a in args))
        jval, jgrad = float(jval), np.asarray(jgrad)
    x = torch.tensor(args[0], dtype=torch.float64, requires_grad=True)
    val = tfn(x, *(torch.from_numpy(a) for a in args[1:]))
    val.backward()
    assert val.dtype == torch.float64
    assert jval > 0
    assert abs(float(val) - jval) <= 1e-12 * abs(jval), (float(val), jval)
    assert _rel(x.grad.numpy(), jgrad) <= 1e-12


def test_relative_depth_clip_keeps_unselected_branches_finite():
    """A pair 1e4 apart: the +-50 clip keeps softplus and the square finite
    in the branches that are not selected, so the loss and gradient are
    finite (the clip of `relative_losses.py:43`)."""
    d = torch.tensor([[0.0, 1e4]], dtype=torch.float64, requires_grad=True)
    loss = trl.relative_depth_loss(d, torch.tensor([[0, 1]]),
                                   torch.ones((1, 2), dtype=torch.bool))
    loss.backward()
    assert torch.isfinite(loss) and torch.isfinite(d.grad).all()
    assert trl.AGE_THRESHOLDS == jrl.AGE_THRESHOLDS


def test_f64_bev_train_step_matches_jax():
    """The same BEV step in float64 on both sides (JAX with x64 on and its
    float32 taken as float64, so that its hard f32 casts keep f64; the port
    with `.float()` taken as `.double()`), with the GMM prior:
    - on the first batch (a tie of depth layers, one person under the depth
      fence): every loss term, gradient tensor and BatchNorm update within
      1e-9 of max|ref| per tensor (measured: gradients 3.5e-12 at the
      median tensor, 9.4e-10 at the worst, `center_map_refiner.0.bn1.
      weight`, a one-channel train-mode BatchNorm3d; BatchNorm updates
      2.2e-14);
    - after two steps (the second batch: unannotated relative labels, a
      masked person): parameters, BatchNorm statistics and both Adam
      moments within 1e-6 of max|ref| per tensor (measured 1.1e-7; after
      the first step 5.1e-15 at the median tensor and 2.8e-8 at the worst,
      a BatchNorm bias: Adam's first update is g / (|g| + 1e-8) an element,
      so where a clipped gradient element is near 1e-8 its relative noise
      passes into the update whole, and the second step's gradients are
      taken at those parameters).
    Weights whose gradient is summation noise on both sides (conv biases
    feeding a train-mode BatchNorm, at most 1e-9 of the largest gradient)
    are left out of the step's comparison: Adam moves each by lr times the
    sign of the noise. Then a third step on a batch with a NaN pixel: both
    sides keep the parameters and moments and commit the (NaN) BatchNorm
    statistics."""
    code = textwrap.dedent("""
        import sys
        import numpy as np, jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        import jax.numpy as jnp
        jnp.float32 = jnp.float64
        import torch
        torch.Tensor.float = torch.Tensor.double
        torch.set_num_threads(2)
        sys.path.insert(0, ".")
        from tests.test_torch_bev_train import (
            SIZE, TINY, from_jax, make_batch, port_config, port_net,
            port_params, smpl_assets, to_jax_layout, torch_batch, _rel)
        from romp_tpu.smpl.body_model import SmplModel as JaxSmpl
        from romp_tpu.train import bev_train_step as jbts
        from romp_tpu.train.priors import GmmPrior as JaxGmm
        from romp_tpu.train.train_step import TrainConfig as JTC
        from romp_tpu_torch.models.layers import record_bn_updates
        from romp_tpu_torch.smpl.body_model import SmplModel
        from romp_tpu_torch.train import bev_train_step as tbts
        from romp_tpu_torch.train.priors import GmmPrior
        from romp_tpu_torch.train.trainer import _unflatten
        f64 = lambda t: jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float64)
            if jnp.issubdtype(a.dtype, jnp.floating) else a, t)
        sd = {k: v.double() if v.is_floating_point() else v
              for k, v in port_params().items()}
        jp = {k: jnp.asarray(v, jnp.float64)
              for k, v in to_jax_layout(sd).items()}
        ja, jb = (f64(JaxSmpl.from_assets(a)) for a in smpl_assets())
        jprior = f64(JaxGmm.synthetic())
        cfg = jbts.BevTrainConfig(base=JTC(compute_dtype="float32"),
                                  input_size=SIZE, backbone=TINY)
        jbatch = [{k: jnp.asarray(v.astype(np.float64)
                                  if v.dtype == np.float32 else v)
                   for k, v in make_batch(s).items()} for s in (0, 1)]
        nan = dict(jbatch[1])
        nan["image"] = nan["image"].at[0, 3, 3, 0].set(jnp.nan)
        jbatch.append(nan)
        state = jbts.bev_init_train_state(jp, cfg)
        (_, (jbn, jm)), jg = jax.jit(lambda a, b, c: jax.value_and_grad(
            jbts.bev_compute_losses, has_aux=True)(
                a, b, c, ja, jb, cfg, jprior))(
            state.trainable, state.bn_state, jbatch[0])
        assert jax.tree_util.tree_leaves(jg)[0].dtype == jnp.float64
        jstep = jax.jit(lambda s, b: jbts.bev_train_step(
            s, b, ja, jb, cfg, jprior))
        jstates = []
        for b in jbatch:
            state, _ = jstep(state, b)
            jstates.append(state)

        tcfg = port_config()
        adult, baby = (SmplModel(a).double() for a in smpl_assets())
        prior = GmmPrior(*(t.double() for t in (
            GmmPrior.synthetic().means, GmmPrior.synthetic().precisions,
            GmmPrior.synthetic().nll_weights)))
        tb = [torch_batch(make_batch(s), torch.float64) for s in (0, 1)]
        tnan = dict(tb[1])
        tnan["image"] = tnan["image"].clone()
        tnan["image"][0, 3, 3, 0] = float("nan")
        tb.append(tnan)
        net = port_net(sd).double().train()
        updates = record_bn_updates(net)
        total, m = tbts.bev_compute_losses(net, tb[0], adult, baby, tcfg,
                                           prior)
        record_bn_updates(net, on=False)
        names = sorted(k for k, _ in net.named_parameters())
        params = dict(net.named_parameters())
        grads = dict(zip(names, torch.autograd.grad(
            total, [params[k] for k in names], allow_unused=True)))
        assert sorted(m) == sorted(jm), (sorted(m), sorted(jm))
        for k, v in jm.items():
            assert abs(float(m[k].detach()) - float(v)) <= 1e-9 * max(
                abs(float(v)), 1e-3), (k, float(m[k]), float(v))
        ref = from_jax(jg)
        gmax = max(float(v.abs().max()) for v in ref.values())
        worst, zero = 0.0, set()
        for k, r in ref.items():
            g = grads[k]
            g = torch.zeros_like(r) if g is None else g
            assert g.dtype == torch.float64, k
            if float(r.abs().max()) <= 1e-9 * gmax:
                assert float(g.abs().max()) <= 1e-9 * gmax, k
                zero.add(k)
                continue
            worst = max(worst, _rel(g.numpy(), r.numpy()))
        assert worst <= 1e-9, worst
        assert sorted(updates) == sorted(jbn)
        bn_worst = max(_rel(updates[k].numpy(), v.numpy())
                       for k, v in from_jax(jbn).items())
        assert bn_worst <= 1e-9, bn_worst

        st = tbts.bev_init_train_state(port_net(sd).double(), tcfg)
        for i, b in enumerate(tb):
            st, tm = tbts.bev_train_step(st, b, adult, baby, tcfg, prior)
            if i == 1:
                after2 = ({k: v.detach().clone()
                           for k, v in st.trainable.items()},
                          {k: v.clone() for k, v in st.bn_state.items()},
                          st.opt_state.mu.clone(), st.opt_state.nu.clone())
        step_worst = 0.0
        j2 = jstates[1]
        adam = next(s for s in jax.tree_util.tree_leaves(
            j2.opt_state, is_leaf=lambda s: hasattr(s, "mu"))
            if hasattr(s, "mu"))
        want = from_jax({**j2.trainable, **j2.bn_state})
        got = {**after2[0], **after2[1]}
        for k, v in got.items():
            if k not in zero:
                step_worst = max(step_worst, _rel(v.numpy(), want[k].numpy()))
        for flat, jdict in ((after2[2], adam.mu), (after2[3], adam.nu)):
            moments = from_jax(jdict)
            for k, v in _unflatten(flat, after2[0]).items():
                if k not in zero:
                    step_worst = max(step_worst,
                                     _rel(v.numpy(), moments[k].numpy()))
        assert step_worst <= 1e-6, step_worst
        # the NaN step: JAX and the port keep the parameters and moments,
        # and commit the statistics
        j3 = jstates[2]
        assert int(j3.step) == int(st.step) == 3
        for k, v in st.trainable.items():
            assert torch.equal(v.detach(), after2[0][k]), k
        assert torch.equal(st.opt_state.mu, after2[2])
        assert int(st.opt_state.count) == 2
        assert int(st.opt_state.notfinite_count) == 1
        jbn3 = from_jax(j3.bn_state)
        n_nan = 0
        for k, v in st.bn_state.items():
            assert torch.equal(torch.isnan(v), torch.isnan(jbn3[k])), k
            n_nan += int(torch.isnan(v).any())
            ok = ~torch.isnan(v)
            if ok.any():
                assert _rel(v[ok].numpy(), jbn3[k][ok].numpy()) <= 1e-9, k
        assert n_nan > 0
        jt2 = from_jax(j2.trainable)
        for k, v in from_jax(j3.trainable).items():
            assert torch.equal(v, jt2[k]), k
        print("OK", worst, bn_worst, step_worst)
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().startswith("OK"), proc.stdout
    print(proc.stdout)


def test_first_batch_has_a_person_under_the_depth_fence():
    """The f64 test's first batch exercises the fence: one person's
    predicted scale puts s * tan + 1e-3 under 0.05 (zero gradient through
    the depth there), another's above it."""
    from romp_tpu_torch.models.bev import (
        bev_forward_maps, bev_regress_params, cam_to_depth_bin,
    )
    from romp_tpu_torch.ops.centermap import CenterDetections3D
    from romp_tpu_torch.pipeline.bev_pipeline import TAN_FOV_HALF

    net = port_net().train()
    b = torch_batch(make_batch(0))
    with torch.no_grad():
        maps = bev_forward_maps(net, b["image"])
        S = maps.center_maps_fv.shape[1]
        c = b["person_centers"]
        cz = cam_to_depth_bin(b["person_scales"], net.anchors)
        cx = torch.clamp(torch.floor((c[..., 0] + 1) / 2 * S), 0, S - 1)
        cy = torch.clamp(torch.floor((c[..., 1] + 1) / 2 * S), 0, S - 1)
        det = CenterDetections3D(
            (cy * S + cx).int(), torch.stack([cz.float(), cy, cx], -1),
            torch.ones(B, P), b["person_mask"])
        cam = bev_regress_params(net, maps, det)[..., :3]
    denom = cam[..., 0] * TAN_FOV_HALF + 1e-3
    assert bool((denom < tbts.DEPTH_FLOOR).any()), denom
    assert bool((denom > tbts.DEPTH_FLOOR).any()), denom


def test_nonfinite_step_commits_batchnorm_unlike_romp():
    """A batch with a NaN pixel: BEV's step (as JAX's, `bev_train_step.py:
    206`) keeps the parameters and moments and commits the BatchNorm
    statistics it recorded, NaN included, and advances `step`; ROMP's step
    on the same weights keeps its statistics (the gate)."""
    cfg = port_config()
    adult, baby = (SmplModel(a) for a in smpl_assets())
    b = torch_batch(make_batch(0))
    b["image"][0, 3, 3, 0] = float("nan")
    state = tbts.bev_init_train_state(port_net(), cfg)
    before = (state.flat.clone(), state.bn_flat.clone())
    state, metrics = tbts.bev_train_step(state, b, adult, baby, cfg)
    assert "grads_finite" not in metrics
    assert torch.equal(state.flat, before[0])
    assert torch.isnan(state.bn_flat).any()
    assert not torch.equal(state.bn_flat, before[1])
    assert int(state.step) == 1 and int(state.opt_state.count) == 0
    assert int(state.opt_state.notfinite_count) == 1
    # ROMP's rule on a NaN step: the statistics stay
    from romp_tpu_torch.models.romp import RompNet, init_romp_params

    rnet = RompNet(TINY)
    rnet.load_state_dict(init_romp_params(torch.Generator().manual_seed(0),
                                          TINY))
    rcfg = tts.TrainConfig(remat="none", backbone=TINY)
    rstate = tts.init_train_state(rnet, rcfg)
    rbn = rstate.bn_flat.clone()
    rb = {k: v for k, v in b.items() if k in (
        "image", "person_centers", "person_bbox_hw", "person_mask",
        "kp2d_gt", "kp3d_gt", "kp3d_mask", "pose_gt", "pose_mask",
        "betas_mask")}
    rb["betas_gt"] = b["betas_gt"][..., :10]
    rstate, rm = tts.train_step(rstate, rb,
                                SmplModel(synthetic_assets(seed=0)), rcfg)
    assert float(rm["grads_finite"]) == 0.0
    assert torch.equal(rstate.bn_flat, rbn)


def test_bev_step_ignores_act_dtype():
    """JAX's BEV step builds its ParamStore with the compute dtype only, so
    `base.act_dtype` is not read: the port's step with act_dtype bfloat16
    gives the same f32 losses and state as with float32, bit for bit."""
    adult, baby = (SmplModel(a) for a in smpl_assets())
    b = torch_batch(make_batch(1))
    out = []
    for act in ("float32", "bfloat16"):
        cfg = port_config(act_dtype=act)
        state = tbts.bev_init_train_state(port_net(), cfg)
        state, m = tbts.bev_train_step(state, b, adult, baby, cfg)
        assert m["total"].dtype == torch.float32
        out.append((state.flat.clone(), state.bn_flat.clone(),
                    {k: float(v) for k, v in m.items()}))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    assert out[0][2] == out[1][2]


def test_bev_train_state_from_jax(tmp_path):
    """A JAX BEV train state (`save_train_state` of a BevTrainState whose
    moments and counters were filled with seeded values) read into the
    port's: every JAX key lands, with its shape and value (parameters,
    BatchNorm statistics, both moments, the counters and the step)."""
    cfg = jbts.BevTrainConfig(base=JaxTrainConfig(), input_size=SIZE,
                              backbone=TINY)
    jp = {k: jnp.asarray(v) for k, v in to_jax_layout(port_params()).items()}
    state = jbts.bev_init_train_state(jp, cfg)
    rng = np.random.RandomState(3)
    leaves, tree = jax.tree_util.tree_flatten(state.opt_state)
    leaves = [jnp.asarray(rng.randn(*np.shape(x)).astype(np.float32))
              if np.asarray(x).dtype == np.float32 else
              jnp.asarray(np.full(np.shape(x), 5, np.asarray(x).dtype))
              if np.asarray(x).dtype == np.int32 else x for x in leaves]
    state = jbts.BevTrainState(state.trainable, state.bn_state,
                               jax.tree_util.tree_unflatten(tree, leaves),
                               jnp.asarray(7, jnp.int32))
    path = str(tmp_path / "bev_state.npz")
    jax_save_train_state(path, state)
    st = bev_train_state_from_jax(path, port_config())
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
        assert sorted(moments) == sorted(st.trainable)
        for k, v in _unflatten(flat, st.trainable).items():
            assert torch.equal(v, moments[k]), k
    assert int(st.step) == 7 and int(st.opt_state.count) == 5
    assert int(st.opt_state.notfinite_count) == 5


def test_bev_synthetic_batch_is_well_formed():
    b = tbts.make_bev_synthetic_batch(3, 2, 3, SIZE, "cpu")
    assert b["betas_gt"].shape == (2, 3, 11)
    assert float(b["betas_gt"][..., 10].abs().max()) == 0.0
    assert b["image"].shape == (2, SIZE, SIZE, 3)
    assert 0.2 <= float(b["person_scales"].min()) <= float(
        b["person_scales"].max()) <= 3.0
    assert int(b["depth_ids"].max()) < 3 and int(b["age_gts"].max()) < 4
    again = tbts.make_bev_synthetic_batch(3, 2, 3, SIZE, "cpu")
    assert all(torch.equal(b[k], again[k]) for k in b)
    # a step on it runs and is finite
    adult, baby = (SmplModel(a) for a in smpl_assets())
    cfg = port_config()
    state = tbts.bev_init_train_state(port_net(), cfg)
    _, m = tbts.bev_train_step(state, b, adult, baby, cfg)
    assert all(np.isfinite(float(v)) for v in m.values())
