"""Shared bodies of the port's data-parallel tests
(`tests/test_torch_parallel.py`, and the card-only counterpart in
`tests/test_torch_kernels_cuda.py`). Each body runs in a child process of
its own (`python tests/torch_parallel_common.py <body> <json args>`), so no
pytest worker ever joins a process group; the parent compares the arrays
the children write.

The ROMP step's data (`global_batch`): the tiny HRNet at 64x64, V = 256,
a global batch of 8 with 4 persons a sample, where the first half (rank 0
of 2) has all 4 persons valid and the second half (rank 1) one, so that
every weighted mean, the BatchNorm statistics and the loss merger's clamp
(`LOSS_THRESH`, between rank 1's local kp2d loss and the global one) tell
the global step from a mean of per-rank steps.
"""
import json
import os
import os.path as osp
import subprocess
import sys
import time

import numpy as np

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
TINY = "hrnet32_tiny"
P = 4                   # persons a sample
# the step's configurations: "tiny" for the CPU tests (f64 against JAX);
# "full" for the card (the full-width HRNet-W32 at 256x256, batch 2, as
# chip_smoke.py's phase 5): on the tiny net an f32 step's distance to the
# f64 one is noise (it moved several-fold from one data seed to another,
# one process or two), where over the full net's 927 tensors its median
# is steady
CONFIGS = {
    "tiny": dict(backbone=TINY, size=64, batch=8, verts=256, remat="stage",
                 # the raw kp2d loss (weighted 400) of the f64 init on the
                 # tiny batch: rank 1's local value 746.9, the global
                 # 1012.3 (train-mode BatchNorm over the global batch
                 # moves every prediction): clamped globally only
                 loss_thresh=900.0),
    "full": dict(backbone="hrnet32", size=256, batch=2, verts=6890,
                 remat="none", loss_thresh=1000.0),
}
LOSS_KEY, LOSS_THRESH = "kp2d", CONFIGS["tiny"]["loss_thresh"]
CHILD_TIMEOUT = 120


def global_batch(config="tiny"):
    """The numpy global batch (f32, as the data pipeline gives it)."""
    c = CONFIGS[config]
    rng = np.random.RandomState(0)
    B, S = c["batch"], c["size"]
    mask = np.zeros((B, P), bool)
    mask[:B // 2] = True            # rank 0: 4 valid persons a sample
    mask[B // 2:, 0] = True         # rank 1: 1
    return {
        "image": (rng.rand(B, S, S, 3) * 255).astype(np.float32),
        "person_centers": rng.uniform(-0.9, 0.9, (B, P, 2)).astype(
            np.float32),
        "person_bbox_hw": np.full((B, P, 2), 0.5, np.float32),
        "person_mask": mask,
        "kp2d_gt": rng.uniform(-1, 1, (B, P, 54, 2)).astype(np.float32),
        "kp3d_gt": (rng.randn(B, P, 54, 3) * 0.3).astype(np.float32),
        "kp3d_mask": mask.copy(),
        "pose_gt": (rng.randn(B, P, 66) * 0.3).astype(np.float32),
        "pose_mask": mask.copy(),
        "betas_gt": (rng.randn(B, P, 10) * 0.5).astype(np.float32),
        "betas_mask": mask.copy(),
    }


def _romp_inputs(dtype, device, config="tiny"):
    import torch

    from romp_tpu_torch.models.romp import RompNet, init_romp_params
    from romp_tpu_torch.smpl.body_model import SmplModel, synthetic_assets
    from romp_tpu_torch.train import train_step as tts
    from romp_tpu_torch.train.priors import GmmPrior

    c = CONFIGS[config]
    net = RompNet(c["backbone"])
    net.load_state_dict(init_romp_params(torch.Generator().manual_seed(0),
                                         c["backbone"]))
    net = net.to(device, dtype)
    cfg = tts.TrainConfig(backbone=c["backbone"], remat=c["remat"],
                          loss_thresh=c["loss_thresh"])
    prior = GmmPrior.synthetic()
    prior = GmmPrior(*(t.to(device, dtype) for t in (
        prior.means, prior.precisions, prior.nll_weights)))
    smpl = SmplModel(synthetic_assets(seed=0, num_verts=c["verts"]),
                     device).to(dtype)
    return net, tts.init_train_state(net, cfg), smpl, prior, cfg


def _to_torch(batch, dtype, device):
    import torch

    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
        device, dtype if v.dtype == np.float32 else None)
        for k, v in batch.items()}


def _flat_grad(net, state, batch, smpl, cfg, prior):
    """The one-process step's flat gradient (state.names order) and its
    raw (unclamped) losses."""
    import dataclasses

    import torch

    from romp_tpu_torch.models.layers import record_bn_updates
    from romp_tpu_torch.train import train_step as tts

    net.train()
    record_bn_updates(net)
    try:
        _, m = tts.compute_losses(
            net, batch, smpl, dataclasses.replace(cfg, loss_thresh=1e300),
            prior)
        params = dict(net.named_parameters())
        grads = torch.autograd.grad(m["total"], [params[k]
                                                 for k in state.names])
    finally:
        record_bn_updates(net, on=False)
    return (torch.cat([g.reshape(-1) for g in grads]).cpu().numpy(),
            {k: float(v) for k, v in m.items()})


def romp_step(out, mode="dp", rank=0, world=1, store=None, device="cpu",
              dtype="float64", backend=None, config="tiny"):
    """One ROMP train step of `CONFIGS[config]`. mode "dp": rank `rank` of
    a `world`-rank group (FileStore `store`) on its rows of the global
    batch; "single": the one-process step on the global batch; "one":
    that, plus the raw gradients and losses of the global batch and of
    each half. Writes the state after the step (flat, bn_flat, mu, nu),
    the metrics (m::) and the step's reduced flat gradient (grad) to
    `out`, and the launches of the port's kernels to `out`.json."""
    import torch

    torch.set_num_threads(1)
    dt = getattr(torch, dtype)
    if dt == torch.float64:
        torch.Tensor.float = torch.Tensor.double   # the losses' casts too
    from romp_tpu_torch.ops.lbs import skinning, skinning_backward
    from romp_tpu_torch.parallel import mesh
    from romp_tpu_torch.train import train_step as tts

    group = None
    if mode == "dp":
        mesh.initialize_distributed(f"file://{store}", world, rank, device,
                                    backend)
        group = mesh.data_group()
    try:
        net, state, smpl, prior, cfg = _romp_inputs(dt, device, config)
        gb = global_batch(config)
        batch = _to_torch(mesh.shard_batch(gb, rank, world) if mode == "dp"
                          else gb, dt, device)
        seen = {}
        update = tts.optimizer_update

        def capture(st, grad, c):
            seen["grad"] = grad.detach().cpu().numpy().copy()
            return update(st, grad, c)

        tts.optimizer_update = capture
        skinning.launches = skinning_backward.launches = 0
        _, metrics = tts.train_step(state, batch, smpl, cfg, prior, group)
        launches = {"skinning": skinning.launches,
                    "skinning_bwd": skinning_backward.launches}
        arrays = {"flat": state.flat, "bn_flat": state.bn_flat,
                  "mu": state.opt_state.mu, "nu": state.opt_state.nu}
        arrays = {k: v.detach().cpu().numpy() for k, v in arrays.items()}
        arrays.update({f"m::{k}": np.float64(v) for k, v in
                       metrics.items()})
        arrays["grad"] = seen["grad"]
        if mode == "one":
            net, state, smpl, prior, cfg = _romp_inputs(dt, device, config)
            halves = []
            for r in range(2):
                g, raw = _flat_grad(net, state, _to_torch(
                    mesh.shard_batch(gb, r, 2), dt, device), smpl, cfg, prior)
                halves.append(g)
                arrays.update({f"raw{r}::{k}": v for k, v in raw.items()})
            g, raw = _flat_grad(net, state, _to_torch(gb, dt, device), smpl,
                                cfg, prior)
            arrays.update({f"raw::{k}": v for k, v in raw.items()})
            arrays["grad_global"] = g
            arrays["grad_halfmean"] = (halves[0] + halves[1]) / 2
        np.savez(out, names=np.array(state.names), **arrays)
        with open(out + ".json", "w") as f:
            json.dump({"launches": launches}, f)
    finally:
        if group is not None:
            mesh.finalize_distributed()


def trainer_fit(out, rank, world, store, ckdir):
    """The Trainer as rank `rank` of `world` (mesh.multihost with an
    explicit coordinator, process count and id), 2 steps of f32 on two
    global batches; writes the state after them to `out`."""
    import torch

    torch.set_num_threads(1)
    from romp_tpu_torch.config import load_config
    from romp_tpu_torch.parallel.mesh import finalize_distributed
    from romp_tpu_torch.smpl.body_model import SmplModel, synthetic_assets
    from romp_tpu_torch.train.trainer import Trainer

    c = CONFIGS["tiny"]
    cfg = load_config(None, overrides=[
        f"model.backbone={TINY}", f"model.input_size={c['size']}",
        f"train.batch_size={c['batch']}", "train.compute_dtype=float32",
        "train.test_interval=2", "train.log_every=1",
        f"train.checkpoint_dir={ckdir}", "train.tensorboard=false",
        "mesh.multihost=true", f"mesh.coordinator=file://{store}",
        f"mesh.num_processes={world}", f"mesh.process_id={rank}"])
    try:
        trainer = Trainer(cfg, SmplModel(synthetic_assets(
            seed=0, num_verts=c["verts"])), device="cpu")
        b = global_batch()
        trainer.fit(iter([b, dict(b, image=b["image"][:, ::-1].copy())]),
                    max_steps=2)
        st = trainer.state
        np.savez(out, flat=st.flat.numpy(), bn_flat=st.bn_flat.numpy(),
                 mu=st.opt_state.mu.numpy(), nu=st.opt_state.nu.numpy(),
                 step=st.step.numpy())
    finally:
        finalize_distributed()


def jax_step(out):
    """JAX's train step (`romp_tpu.train.train_step.train_step`) under
    `make_mesh(2)` on the global batch, in float64 (x64 on, JAX's float32
    taken as float64, as `test_torch_train_launch.py`'s f64 test does),
    from the port's seeded init: writes the metrics (m::), the BatchNorm
    statistics (b::) and Adam's first moment (mu::, in the port's layouts)
    after the step to `out`."""
    os.environ["XLA_FLAGS"] = " ".join((
        "--xla_force_host_platform_device_count=8",   # tests/conftest.py's
        "--xla_cpu_multi_thread_eigen=false", "intra_op_parallelism_threads=1"))
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    jnp.float32 = jnp.float64
    import torch

    torch.set_num_threads(1)
    from jax.sharding import NamedSharding, PartitionSpec

    from romp_tpu.parallel.mesh import make_mesh, shard_batch
    from romp_tpu.smpl.assets import synthetic_assets
    from romp_tpu.smpl.body_model import SmplModel
    from romp_tpu.train import train_step as jts
    from romp_tpu.train.priors import GmmPrior
    from romp_tpu_torch.models.romp import init_romp_params
    from romp_tpu_torch.utils.checkpoint import state_dict_from_jax

    def f64(tree):
        return jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float64)
            if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)

    sd = init_romp_params(torch.Generator().manual_seed(0), TINY)
    params = f64({k: jnp.asarray(v.numpy().transpose(2, 3, 1, 0)
                                 if v.dim() == 4 else v.numpy())
                  for k, v in sd.items()
                  if not k.endswith("num_batches_tracked")})
    cfg = jts.TrainConfig(backbone=TINY, remat="none",
                          loss_thresh=LOSS_THRESH)
    smpl = f64(SmplModel.from_assets(synthetic_assets(
        seed=0, num_verts=CONFIGS["tiny"]["verts"])))
    mesh = make_mesh(2)
    repl = NamedSharding(mesh, PartitionSpec())
    with jax.set_mesh(mesh):
        state = jax.device_put(jts.init_train_state(params, cfg), repl)
        prior = jax.device_put(f64(GmmPrior.synthetic()), repl)
        batch = shard_batch(f64({k: jnp.asarray(v)
                                 for k, v in global_batch().items()}), mesh)
        new, metrics = jax.jit(lambda s, b: jts.train_step(
            s, b, smpl, cfg, prior))(state, batch)

    def adam_mu(s):
        if hasattr(s, "mu"):
            return s.mu
        for x in (s if isinstance(s, tuple) else ()):
            found = adam_mu(x)
            if found is not None:
                return found
        return None

    arrays = {f"m::{k}": np.asarray(v) for k, v in metrics.items()}
    arrays.update({f"b::{k}": np.asarray(v)
                   for k, v in new.bn_state.items()})
    mu = state_dict_from_jax({k: np.asarray(v)
                              for k, v in adam_mu(new.opt_state).items()})
    arrays.update({f"mu::{k}": v.numpy() for k, v in mu.items()})
    np.savez(out, **arrays)


def grad_distances(grad, ref, names, config="tiny"):
    """Per-tensor relative errors (max |a - b| / max |b|) of a flat
    gradient against a reference, in the names' order, leaving out the
    tensors whose reference is exactly zero (under 1e-6 of the largest):
    (median, max)."""
    import statistics

    from romp_tpu_torch.models.romp import RompNet

    sizes = {k: v.numel() for k, v in RompNet(
        CONFIGS[config]["backbone"]).state_dict().items()}
    gmax = np.abs(ref).max()
    errs, offset = [], 0
    for k in names:
        a, b = grad[offset:offset + sizes[k]], ref[offset:offset + sizes[k]]
        offset += sizes[k]
        if np.abs(b).max() > 1e-6 * gmax:
            errs.append(float(np.abs(a - b).max() / np.abs(b).max()))
    return statistics.median(errs), max(errs)


BODIES = {"romp_step": romp_step, "trainer_fit": trainer_fit,
          "jax_step": jax_step}


class Child:
    """A child process with a hard timeout, in a session of its own: `kill`
    ends it and whatever it started."""

    def __init__(self, argv, timeout=CHILD_TIMEOUT, env=None):
        self.timeout = timeout
        self.t0 = time.time()
        self.proc = subprocess.Popen(
            argv, cwd=REPO, start_new_session=True, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
            env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                     **(env or {})))

    def result(self):
        """(exit code, output); kills the child at its timeout."""
        try:
            out, _ = self.proc.communicate(
                timeout=max(1.0, self.timeout - (time.time() - self.t0)))
        except subprocess.TimeoutExpired:
            self.kill()
            out, _ = self.proc.communicate()
            return 124, out
        return self.proc.returncode, out

    def kill(self):
        if self.proc.poll() is None:
            try:
                os.killpg(self.proc.pid, 9)
            except ProcessLookupError:
                pass


def body(name, **kwargs):
    """A Child running `BODIES[name](**kwargs)`."""
    return Child([sys.executable, osp.abspath(__file__), name,
                  json.dumps(kwargs)])


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    BODIES[sys.argv[1]](**json.loads(sys.argv[2]))
