"""Data parallelism over processes with torch.distributed (counterpart of
`romp_tpu/parallel/mesh.py`).

The JAX package runs one SPMD program over a device mesh: the batch axis is
sharded, the parameters replicated, and XLA inserts the psums that make a
sharded step equal to the one-device step on the whole batch. Here one
process drives one device, the processes form a torch.distributed group,
and the reductions are written out. The rule they keep: a step on W ranks,
each holding B/W rows of a global batch of B, leaves every rank with the
parameters, BatchNorm statistics, optimizer state and metrics of the
one-process step on all B rows.

- Train-mode BatchNorm sums x and x^2 over the ranks (`models/layers.py`).
- Every mean over the batch sums its numerator and denominator over the
  ranks (`global_ratio`; `train/losses.py`, `train/heatmap_ae.py`,
  `train/priors.py`, TRACE's mean over clips), so each rank computes the
  same global losses, and the loss merger clamps global values.
- The flat gradient is all-reduced once a step (`all_reduce_grad`).

`global_sum`'s backward sums the cotangents of all ranks: the adjoint of
the sum, so that nested reductions (a BatchNorm's statistics feeding a
global loss) back-propagate exactly. As every rank back-propagates the
same global loss, each rank's gradient is W times its share, and
`all_reduce_grad` divides the summed gradient by W.

With no group (`group=None`: one process, or a group of one) none of this
runs a collective or changes a result: every helper returns its input.

Launch: `mesh.n_devices=N` starts N processes on one host
(`spawn_local`), each on `local_device(rank)`; `mesh.multihost=true` with
`mesh.coordinator` / `mesh.num_processes` / `mesh.process_id` joins this
process as that rank (one process per host and card, started by the user
on every host).
"""
from __future__ import annotations

import os
import os.path as osp
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# ------------------------------------------------------------ the group --


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device=None, backend: Optional[str] = None
                           ) -> None:
    """Join a job of `num_processes` processes as rank `process_id`
    (`initialize_distributed` of the JAX package, given its three values
    explicitly: nothing here detects a cluster).

    coordinator: "host:port" or "tcp://host:port" (rank 0 listens there),
    or "file:///path" (a FileStore all processes can reach; the file must
    not exist before the job). One process drives one device, `device`
    ("cuda" alone: `local_device(process_id)`).
    The backend is NCCL on a CUDA device and gloo on the CPU; `backend`
    names another (gloo with CUDA tensors, where two ranks share a card,
    which NCCL refuses). A no-op for at most one process; a process that
    already joined a group of the same size and rank stays in it, one of
    another size or rank raises."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator is None or process_id is None:
        raise ValueError("initialize_distributed: a job of several "
                         "processes needs the coordinator's address and "
                         "this process's id")
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (num_processes,
                                                        process_id):
            raise RuntimeError(
                f"already rank {dist.get_rank()} of {dist.get_world_size()}"
                f", asked for rank {process_id} of {num_processes}")
        return
    device = torch.device(device if device is not None else "cpu")
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device if device.index is not None
                              else local_device(process_id))
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def data_group():
    """The group a data-parallel step reduces over: the default group when
    this process is one of several, else None (no collective runs)."""
    return dist.group.WORLD if process_count() > 1 else None


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def initialize_from_config(mesh, device):
    """Join the job `mesh` (a `config.MeshConfig`) describes, and return
    the group the steps reduce over (None for one process).
    `mesh.multihost`: this process is rank `mesh.process_id` of
    `mesh.num_processes`, rendezvous at `mesh.coordinator`.
    `mesh.n_devices` > 1 without it: the processes are started by
    `spawn_local` (the launchers do), which sets the multihost fields."""
    if mesh.multihost:
        initialize_distributed(mesh.coordinator, mesh.num_processes,
                               mesh.process_id, device)
    elif (mesh.n_devices or 1) > 1 and process_count() != mesh.n_devices:
        raise ValueError(
            f"mesh.n_devices={mesh.n_devices} trains in {mesh.n_devices} "
            "processes: start them with the launcher (python -m "
            "romp_tpu_torch.train.launch / .pretrain), or give this "
            "process its rank with mesh.multihost=true mesh.coordinator=..."
            " mesh.num_processes=... mesh.process_id=...")
    return data_group()


def local_device(rank: int, cpu: bool = False) -> torch.device:
    """The device of a rank: the CPU when `cpu`, else
    cuda:(rank mod the number of cards this host sees), so the ranks of one
    host take its cards in order."""
    if cpu:
        return torch.device("cpu")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(f"rank {rank} asks for a card, and this machine "
                           "has none; pass --GPU -1 to train on the CPU")
    return torch.device("cuda", rank % n)


# ------------------------------------------------------- batch and state --


def shard_batch(batch: Dict, rank: Optional[int] = None,
                world: Optional[int] = None) -> Dict:
    """This rank's rows of a global batch (a dict of arrays or tensors,
    batch on the leading axis): rows [r B / W, (r + 1) B / W). Raises
    unless W divides B. The counterpart of the JAX package's
    `shard_batch_global`, where each process supplies its own rows; with
    one process the batch itself."""
    rank = process_index() if rank is None else rank
    world = process_count() if world is None else world
    if world == 1:
        return batch
    sizes = {len(v) for v in batch.values()}
    if len(sizes) != 1:
        raise ValueError(f"shard_batch: leading sizes differ: {sizes}")
    (b,) = sizes
    if b % world:
        raise ValueError(f"shard_batch: a global batch of {b} does not "
                         f"split over {world} ranks")
    n = b // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


@torch.no_grad()
def replicate_tree(tensors: Iterable[torch.Tensor], group=None) -> None:
    """Broadcast rank 0's values of `tensors` to every rank, in place (the
    replicated state at the start of a run). Nothing with no group."""
    if group is None:
        return
    for t in tensors:
        dist.broadcast(t, src=0, group=group)


_INT_VIEW = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


@torch.no_grad()
def check_replicas(tensors: Iterable[torch.Tensor], group=None) -> None:
    """Raise unless every rank of `group` holds bitwise the same values of
    `tensors` (a fingerprint of their bits a tensor, compared by two
    collectives): the end of a data-parallel run. Nothing with no group."""
    if group is None:
        return
    fp = []
    for t in tensors:
        bits = t.detach().reshape(-1).contiguous()
        bits = (bits.to(torch.int64) if bits.dtype == torch.bool
                else bits.view(_INT_VIEW[bits.element_size()]).to(
                    torch.int64))
        pos = torch.arange(1, bits.numel() + 1, device=bits.device)
        fp += [bits.sum(), (bits * pos).sum()]
    lo = torch.stack(fp)
    hi = lo.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    if not torch.equal(lo, hi):
        raise RuntimeError("the ranks' replicas differ")


# ------------------------------------------------------------ reductions --


class _GlobalSum(torch.autograd.Function):
    """all_reduce(SUM) whose backward all-reduces the cotangent: the
    adjoint of the sum when every rank's output is a term of the
    objective."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def global_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of `x` over the ranks of `group`, with autograd (see the
    module's note on the gradient); `x` itself with no group."""
    if group is None:
        return x
    return _GlobalSum.apply(x, group)


def global_sums(*xs: torch.Tensor, group=None) -> Tuple[torch.Tensor, ...]:
    """`global_sum` of several tensors of one dtype in one collective."""
    if group is None:
        return xs
    flat = global_sum(torch.cat([x.reshape(-1) for x in xs]), group)
    out, offset = [], 0
    for x in xs:
        out.append(flat[offset:offset + x.numel()].view(x.shape))
        offset += x.numel()
    return tuple(out)


def global_ratio(num: torch.Tensor, den: torch.Tensor, eps: float,
                 group=None) -> torch.Tensor:
    """num / (den + eps), numerator and denominator summed over the ranks
    first: a weighted mean over the global batch."""
    num, den = global_sums(num, den, group=group)
    return num / (den + eps)


@torch.no_grad()
def all_reduce_grad(grad: torch.Tensor, group=None) -> torch.Tensor:
    """The step's flat gradient summed over the ranks and divided by W, in
    place (one collective a step); `grad` as it is with no group."""
    if group is not None:
        dist.all_reduce(grad, group=group)
        grad.div_(group_size(group))
    return grad


# -------------------------------------------------------------- serving --


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> List[torch.device]:
    """The devices a server replicates its weights on: `devices` as given
    (a device may repeat: two replicas on one card), else the first
    `n_devices` cards (all when None); raises when the machine has fewer."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        return devs[:n_devices] if n_devices is not None else devs
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n_devices is None else int(n_devices)
    if n < 1 or n > have:
        raise RuntimeError(f"a mesh of {n} cards asked for; this machine "
                           f"has {have}")
    return [torch.device("cuda", i) for i in range(n)]


# -------------------------------------------------------------- launch --


def spawn_local(module: str, argv: Sequence[str], n: int,
                timeout: Optional[float] = None) -> int:
    """Run `python -m <module> <argv>` as ranks 0..n-1 of one job on this
    host, with a FileStore rendezvous in a fresh temporary directory: each
    gets `mesh.multihost=true mesh.coordinator=file://... mesh.num_processes
    =n mesh.process_id=r` after `argv`, and OMP_NUM_THREADS (unless set) of
    the host's cores over n. Waits for all; when one fails, stops the rest
    (they would wait in a collective for it). Returns the first non-zero
    exit code, else 0."""
    tmp = tempfile.mkdtemp(prefix="romp_tpu_torch_dp_")
    root = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    env.setdefault("OMP_NUM_THREADS",
                   str(max(1, (os.cpu_count() or 1) // n)))
    store = "file://" + osp.join(tmp, "rendezvous")
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, *argv, "mesh.multihost=true",
         f"mesh.coordinator={store}", f"mesh.num_processes={n}",
         f"mesh.process_id={r}"], env=env) for r in range(n)]
    deadline = None if timeout is None else time.time() + timeout
    rc = 0
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c]
            if failed:
                rc = failed[0]
                break
            if all(c == 0 for c in codes):
                break
            if deadline is not None and time.time() > deadline:
                rc = 124
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return rc


def launch_ranks(mesh, module: str, argv: Sequence[str]) -> Optional[int]:
    """A launcher's first step: with `mesh.n_devices` > 1 and no rank of
    its own (not `mesh.multihost`), run `module` with `argv` as that many
    ranks on this host (`spawn_local`) and return their exit code; else
    None (this process trains)."""
    if (mesh.n_devices or 1) > 1 and not mesh.multihost:
        return spawn_local(module, argv, mesh.n_devices)
    return None


def finalize_distributed() -> None:
    """Leave the group this process joined (the end of a launcher run)."""
    if dist.is_initialized():
        dist.destroy_process_group()

