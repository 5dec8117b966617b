"""The port's data parallelism (`romp_tpu_torch/parallel/mesh.py`, the
counterpart of `romp_tpu/parallel/mesh.py`) on the CPU.

The helpers at world size 1 (as `tests/test_mesh.py`), then multi-process
runs over gloo, each child a process of its own with a FileStore
rendezvous under the test's temporary directory (no TCP port), one thread,
a hard timeout and its group destroyed at its end (`torch_parallel_common.
py`); no group is ever made in the pytest worker. The children of the
module's `jobs` start together and the tests read their results:
- the f64 ROMP step on 2 ranks against the one-process step on the global
  batch and against JAX's `train_step` under `make_mesh(2)`, on data where
  the mean of per-rank steps is another step;
- the Trainer as two explicit ranks (`mesh.multihost`);
- the ROMP, TRACE and pretraining launchers with `mesh.n_devices=2`
  against their one-process runs on the same data.
Serving over two replicas runs in the worker itself (no group).
"""
import json
import os
import os.path as osp
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from romp_tpu_torch.config import MeshConfig
from romp_tpu_torch.parallel import mesh
from tests import torch_parallel_common as common
from tests.torch_parallel_common import Child, body

LAUNCHERS = {"romp": "romp_tpu_torch.train.launch",
             "trace": "romp_tpu_torch.train.launch",
             "pretrain": "romp_tpu_torch.train.pretrain"}
LOGS = {"romp": "train_log.jsonl", "trace": "trace_train_log.jsonl",
        "pretrain": "pretrain_log.jsonl"}
LASTS = {"romp": "last.npz", "trace": "trace_last.npz",
         "pretrain": "pretrain_last.npz"}
# the first step's losses in f32 on 2 ranks and on one process: the global
# reductions add in another order (measured: ROMP 1.2e-6, pretraining
# 6.6e-6, TRACE 0 relative)
FIRST_LOSS_RTOL = 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _launcher_args(kind, root, ck):
    args = ["--GPU", "-1", "--data_root", osp.join(root, "data"),
            "model.input_size=64", "train.batch_size=2",
            "train.compute_dtype=float32", "train.log_every=1",
            f"train.checkpoint_dir={ck}", "train.tensorboard=false"]
    if kind == "romp":
        return args + ["--max_steps", "2", "model.backbone=hrnet32_tiny",
                       "train.test_interval=0", "data.datasets=mini"]
    if kind == "trace":
        return args + ["--max_steps", "2", "model.version=trace",
                       "model.backbone=hrnet32_tiny", "data.datasets=clips",
                       "trace.clip_length=2", "trace.max_tracks=2"]
    # pretraining: the full HRNet-W32 (its launcher builds no tiny one)
    return args + ["--max_steps", "1", "data.datasets=mini"]


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Every multi-process job of the module, started at once."""
    from tests.test_torch_train_launch import _write_pack, write_video_pack

    root = str(tmp_path_factory.mktemp("dp"))
    _write_pack(root)
    write_video_pack(root)
    running = {}

    def out(name):
        return osp.join(root, name)

    running["jax"] = body("jax_step", out=out("jax.npz"))
    running["one"] = body("romp_step", out=out("one.npz"), mode="one")
    for r in range(2):
        running[f"dp{r}"] = body("romp_step", out=out(f"dp{r}.npz"), rank=r,
                                 world=2, store=out("dp_store"))
        running[f"trainer{r}"] = body(
            "trainer_fit", out=out(f"trainer{r}.npz"), rank=r, world=2,
            store=out("trainer_store"), ckdir=out(f"trainer_ck{r}"))
    for kind, module in LAUNCHERS.items():
        for ranks in (1, 2):
            ck = out(f"{kind}_ck{ranks}")
            running[f"{kind}{ranks}"] = Child(
                [sys.executable, "-m", module,
                 *_launcher_args(kind, root, ck),
                 *([f"mesh.n_devices={ranks}"] if ranks > 1 else [])])
    try:
        yield root, running
    finally:
        for child in running.values():
            child.kill()


def _done(running, *names):
    for name in names:
        rc, log = running[name].result()
        assert rc == 0, f"{name} exited {rc}:\n{log[-4000:]}"


# ----------------------------------------------------------- world size 1 --

def test_initialize_distributed_one_process_is_a_no_op():
    mesh.initialize_distributed(num_processes=1)
    mesh.initialize_distributed("file:///nonexistent/store", 1, 0)
    assert not dist.is_initialized()
    assert (mesh.process_index(), mesh.process_count()) == (0, 1)
    assert mesh.data_group() is None
    assert mesh.initialize_from_config(MeshConfig(), "cpu") is None
    assert mesh.initialize_from_config(MeshConfig(n_devices=1), "cpu") is None
    with pytest.raises(ValueError, match="launcher"):
        mesh.initialize_from_config(MeshConfig(n_devices=2), "cpu")
    with pytest.raises(ValueError, match="coordinator"):
        mesh.initialize_distributed(None, 2, 0)
    assert not dist.is_initialized()


def test_shard_batch_takes_the_ranks_rows_and_refuses_uneven_splits():
    batch = {"x": np.arange(12).reshape(6, 2), "y": torch.arange(6)}
    assert mesh.shard_batch(batch) is batch          # one process
    for rank in range(3):
        part = mesh.shard_batch(batch, rank, 3)
        np.testing.assert_array_equal(part["x"], batch["x"][2 * rank:
                                                            2 * rank + 2])
        assert part["y"].tolist() == [2 * rank, 2 * rank + 1]
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard_batch(batch, 0, 4)
    with pytest.raises(ValueError, match="differ"):
        mesh.shard_batch({"x": np.zeros(4), "y": np.zeros(2)}, 0, 2)


def test_reductions_are_the_identity_without_a_group():
    x = torch.randn(5, requires_grad=True)
    assert mesh.global_sum(x) is x
    a, b = torch.randn(3), torch.randn(())
    assert mesh.global_sums(a, b) == (a, b)
    num, den = torch.tensor(3.0), torch.tensor(7.0)
    assert torch.equal(mesh.global_ratio(num, den, 1e-6),
                       num / (den + 1e-6))
    g = torch.randn(4)
    assert mesh.all_reduce_grad(g) is g
    mesh.replicate_tree([g])
    mesh.check_replicas([g])
    assert mesh.group_size(None) == 1
    assert mesh.make_mesh(devices=["cpu", "cpu"]) == [torch.device("cpu")] * 2
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="cards"):
            mesh.make_mesh(2)


def test_one_process_step_runs_no_collective(monkeypatch):
    """With no group the ROMP step (remat "stage") calls no
    torch.distributed function."""
    from romp_tpu_torch.train import train_step as tts
    from tests.torch_parallel_common import _romp_inputs, _to_torch

    def refuse(*args, **kwargs):
        raise AssertionError("a collective ran")

    for name in ("all_reduce", "broadcast", "all_gather", "barrier"):
        monkeypatch.setattr(dist, name, refuse)
    batch = _to_torch(mesh.shard_batch(common.global_batch(), 0, 4),
                      torch.float32, "cpu")
    _, state, smpl, prior, cfg = _romp_inputs(torch.float32, "cpu")
    _, m = tts.train_step(state, batch, smpl, cfg, prior)
    assert m["grads_finite"] == 1.0 and torch.isfinite(m["total"])


# -------------------------------------------------------- several ranks --

def _state(root, name):
    with np.load(osp.join(root, name)) as data:
        return {k: data[k] for k in data.files}


def test_two_rank_f64_step_is_the_global_step(jobs):
    """Both ranks end bitwise equal, and equal to the one-process step on
    the global batch to 1e-10 of each state buffer's largest value
    (measured 3.8e-11 for the parameters, where Adam's first step divides
    by |g| + 1e-8), while the mean of the two halves' one-process
    gradients misses the global gradient by far more than 1e-4 (1.3 here):
    the data tells the global step from per-rank means. The merger's
    threshold sits between rank 1's local kp2d loss and the global one, so
    it clamps the global value only."""
    root, running = jobs
    _done(running, "dp0", "dp1", "one")
    r0, r1, one = (_state(root, f) for f in ("dp0.npz", "dp1.npz",
                                              "one.npz"))
    for k in r0:
        assert np.array_equal(r0[k], r1[k]), k
    for k in ("flat", "bn_flat", "mu", "nu", "grad"):
        assert _rel(r0[k], one[k]) <= 1e-10, (k, _rel(r0[k], one[k]))
    for k in (k for k in one if k.startswith("m::")):
        assert abs(float(r0[k]) - float(one[k])) <= 1e-10 * max(
            abs(float(one[k])), 1e-3), k
    assert _rel(one["grad_halfmean"], one["grad_global"]) > 1e-4
    key, thresh = f"::{common.LOSS_KEY}", common.LOSS_THRESH
    assert float(one["raw1" + key]) < thresh < float(one["raw" + key])
    assert float(r0["m" + key]) == pytest.approx(thresh, rel=1e-12)
    assert float(one["raw0::centermap"]) < 1000.0 < float(
        one["raw1::centermap"])      # and the default threshold, rank 1's


def test_two_rank_f64_step_matches_jax_mesh_step(jobs):
    """Against JAX's `train_step` under `make_mesh(2)` on the same global
    batch, both in f64, at `test_f64_train_step_matches_jax`'s bars: the
    losses and the BatchNorm statistics within 1e-9 relative, Adam's first
    moment ((1 - b1) times the clipped gradient) within 1e-6 of each
    tensor's largest value (measured 5.5e-8); the three conv biases whose
    gradient is exactly zero hold summation noise (1e-9 of the largest)."""
    from romp_tpu_torch.models.romp import RompNet
    from romp_tpu_torch.train.train_step import split_params
    from tests.test_torch_train_step import ZERO_GRAD

    root, running = jobs
    _done(running, "dp0", "jax")
    r0, ref = _state(root, "dp0.npz"), _state(root, "jax.npz")
    shapes = {k: v.shape for k, v in
              RompNet(common.TINY).state_dict().items()}
    _, bn = split_params(shapes)

    def unflatten(flat, names):
        out, offset = {}, 0
        for k in names:
            n = int(np.prod(shapes[k]))
            out[k] = flat[offset:offset + n].reshape(shapes[k])
            offset += n
        return out

    for k in (k for k in ref if k.startswith("m::")):
        assert abs(float(r0[k]) - float(ref[k])) <= 1e-9 * max(
            abs(float(ref[k])), 1e-3), k
    bns = unflatten(r0["bn_flat"], sorted(bn))
    assert max(_rel(bns[k[3:]], v) for k, v in ref.items()
               if k.startswith("b::")) <= 1e-9
    mu = unflatten(r0["mu"], [str(n) for n in r0["names"]])
    gmax = max(np.abs(v).max() for k, v in ref.items() if k.startswith("mu::"))
    worst = 0.0
    for k, v in ((k[4:], v) for k, v in ref.items() if k.startswith("mu::")):
        if k in ZERO_GRAD:
            assert np.abs(mu[k]).max() <= 1e-9 * gmax, k
            continue
        worst = max(worst, _rel(mu[k], v))
    assert worst <= 1e-6, worst


def test_trainer_multihost_ranks_agree_and_rank0_alone_writes(jobs):
    """The Trainer with mesh.multihost, an explicit coordinator,
    num_processes=2 and process_id: both ranks end bitwise equal after 2
    steps (and `Trainer.fit` checks it), and only rank 0 writes
    train_log.jsonl, the step snapshot and last.npz."""
    root, running = jobs
    _done(running, "trainer0", "trainer1")
    t0, t1 = _state(root, "trainer0.npz"), _state(root, "trainer1.npz")
    for k in t0:
        assert np.array_equal(t0[k], t1[k]), k
    assert int(t0["step"]) == 2
    ck0, ck1 = (osp.join(root, f"trainer_ck{r}") for r in range(2))
    with open(osp.join(ck0, "train_log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    assert [r["step"] for r in log] == [1, 2]
    assert all(r["grads_finite"] == 1.0 for r in log)
    assert osp.exists(osp.join(ck0, "last.npz"))
    assert osp.exists(osp.join(ck0, "step_00000002.npz"))
    assert not [f for f in os.listdir(ck1)
                if f.endswith(".npz") or f.endswith(".jsonl")]


@pytest.mark.parametrize("kind", sorted(LAUNCHERS))
def test_launcher_with_two_ranks_matches_one_process(jobs, kind):
    """`mesh.n_devices=2 --GPU -1` starts two ranks on the CPU (the
    launcher's local rendezvous): they run to the end (each launcher checks
    at its end that the ranks' states are bitwise equal), rank 0 alone
    writes the log and checkpoint, and the first step's losses equal the
    one-process run's on the same data within FIRST_LOSS_RTOL."""
    root, running = jobs
    _done(running, f"{kind}1", f"{kind}2")
    logs = []
    for ranks in (1, 2):
        ck = osp.join(root, f"{kind}_ck{ranks}")
        with open(osp.join(ck, LOGS[kind])) as f:
            logs.append([json.loads(line) for line in f])
        assert osp.exists(osp.join(ck, LASTS[kind]))
    one, two = logs
    assert [r["step"] for r in two] == [r["step"] for r in one]
    for k, v in one[0].items():
        if k in ("step", "steps_per_sec") or not isinstance(v, float):
            continue
        assert abs(two[0][k] - v) <= FIRST_LOSS_RTOL * max(abs(v), 1e-3), (
            k, two[0][k], v)


# -------------------------------------------------------------- serving --

def test_serving_over_two_replicas_matches_one_device():
    """`make_romp_service(mesh=...)` over two CPU replicas: padded sizes
    are multiples of 2, three requests go out as one batch padded to 4 and
    split 2 + 2, and every image's results are bitwise the one-device
    service's on the same two-image shards (zero-padded as the batcher
    pads); a max_batch that is not a multiple of the replicas raises."""
    from romp_tpu_torch.models.romp import init_romp_params
    from romp_tpu_torch.pipeline.romp_pipeline import RompConfig
    from romp_tpu_torch.serve import make_romp_service
    from romp_tpu_torch.smpl.body_model import SmplModel, synthetic_assets

    params = init_romp_params(torch.Generator().manual_seed(0), common.TINY)
    smpl = SmplModel(synthetic_assets(seed=0))
    cfg = RompConfig(input_size=64, max_person=4, conf_thresh=-1e9,
                     backbone=common.TINY)
    replicas = mesh.make_mesh(devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="multiple"):
        make_romp_service(params, smpl, cfg, max_batch=3, mesh=replicas)
    mb = make_romp_service(params, smpl, cfg, max_batch=4, window_ms=50.0,
                           mesh=replicas)
    ref = make_romp_service(params, smpl, cfg, max_batch=2, device="cpu")
    try:
        assert mb.sizes == [2, 4]
        rng = np.random.RandomState(0)
        imgs = np.zeros((4, 64, 64, 3), np.uint8)
        imgs[:3] = rng.rand(3, 64, 64, 3) * 255
        res = [f.result(timeout=120) for f in [mb.submit(im)
                                               for im in imgs[:3]]]
        assert mb.batches_run == 1            # one batch padded to 4
        shards = [ref.fetch(ref.run_batch(imgs[i:i + 2])) for i in (0, 2)]
        for i, r in enumerate(res):
            r0 = {k: v[i % 2] for k, v in shards[i // 2].items()}
            assert sorted(r) == sorted(r0)
            for k, v in r0.items():
                np.testing.assert_array_equal(r[k], v, err_msg=k)
    finally:
        mb.close()
        ref.close()


def test_serve_flag_mesh_devices_reaches_the_service():
    """`--mesh_devices 2 --GPU -1` builds the service over two CPU
    replicas through `build_server`, which refuses a max_batch that the
    replicas do not divide (the JAX server's assertion)."""
    from romp_tpu_torch.serve import build_server, serve_args

    assert serve_args([]).mesh_devices == 0
    with pytest.raises(ValueError, match="multiple of the 2 replicas"):
        build_server(serve_args(["--GPU", "-1", "--mesh_devices", "2",
                                 "--max_batch", "3", "--port", "0",
                                 "--model_path", "/nonexistent.pkl"]))
