"""Data parallelism over the cards: port of ``levelgan/dist/mesh.py``.

The JAX package shards the global batch on a 1-D mesh ``('data',)``,
replicates the parameters, and XLA emits the gradient all-reduce, so every
batch-level reduction of a step (a mean, a sum, a ratio of sums) is over
the global batch.  Here the mesh is one process per card (a rank): NCCL on
the card, gloo on the CPU, and the collectives are explicit:

- every rank holds the whole state, draws the whole step's batch indices
  and noise from the step's generator and keeps its slice (``shard``), so
  a data-parallel step computes what the single-process step computes on
  the same global batch, up to the order of the all-reduce's sums;
- ``all_reduce_grads``: each update's gradients in one flat buffer, in
  parameter order, summed over the ranks and divided by their number (one
  collective an update; every rank gets the same bits);
- ``global_sum``: a differentiable sum over the ranks (sum forward, sum
  backward), for the batch statistics that feed a loss or a decision;
- ``global_var``: the population variance over the global batch, two-pass
  from two ``global_sum`` calls, for the critic's minibatch-stddev channel
  (``model.critic_mbstd``): twice differentiable, so the gradient
  penalty's input gradient and its double backward into the weights gain
  the cross-sample terms of the whole batch, as the JAX package's sharded
  ``var(axis=0)`` does;
- ``any_rank`` / ``barrier``: host-side agreement on a stop and the wait
  after a checkpoint write, over a gloo group (no device sync).

The collectives run whenever a process group exists, at world size 1 too
(each is exact there; ``global_var`` there is the local ``var``); outside
one every helper is the identity.  ``collectives`` counts the device
collectives this process issued, by helper (a backward's ``global_sum``
included).

``make_plan`` maps ``dist.dp`` / ``coordinator_address`` /
``num_processes`` / ``process_id`` to the ranks this process starts, and
``launch`` starts them (``torch.multiprocessing``, spawn): each sets its
card before anything touches it, joins the group and runs the function.
A process that a launcher such as torchrun started (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR`` in its environment)
joins its group instead (``join_from_env``).  The launching process
forwards SIGTERM / SIGINT to its ranks; a second signal kills them.  A
launch may be given a deadline, past which its ranks are killed and it
raises ``TimeoutError``; the group is joined with ``GROUP_TIMEOUT_S``, so
a collective that a stalled rank never enters raises instead of blocking.

Not ported: the JAX package's ``tp`` axis and ``tp_param_sharding`` (the
tensor-parallel hook has no config entry point).
"""

from __future__ import annotations

import collections
import datetime
import os
import pickle
import shutil
import signal
import tempfile
import threading
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

# draws whose batch axis is 1: the rollouts' action noise [T, B, n]
TIME_MAJOR = ("rollout_strong", "rollout_weak")
_ENV_RANK = ("GROUP_RANK", "NODE_RANK")   # a launcher's host index
_host_group = None                        # gloo group of this rank's process
_launcher = None                          # pid of the process that launched it
GROUP_TIMEOUT_S = 600.0   # a rendezvous or collective waits at most this
# device collectives issued by this process, by helper
collectives: collections.Counter = collections.Counter()


@dataclass(frozen=True)
class Plan:
    """The ranks of a run: ``world`` in all, ``local`` started by this
    process with global ranks ``first_rank ..``, joined through
    ``init_method`` (``None``: a file store the launcher makes)."""
    world: int
    local: int
    first_rank: int
    device_type: str
    init_method: str | None = None


def visible_devices(device_type: str) -> int:
    """The cards a mesh may span; the CPU runs up to one rank a core."""
    if device_type == "cuda":
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def mesh_size(dp: int, devices: int) -> int:
    """``dp`` ranks (0: every device), as ``make_mesh`` sizes its mesh."""
    n = dp if dp > 0 else devices
    if n > devices:
        raise ValueError(f"requested dp={n} but only {devices} devices")
    return n


def make_plan(dist_cfg, device_type: str) -> Plan:
    """The ranks ``dist_cfg`` asks for.  ``dp`` counts the ranks of all
    hosts (0: every card of each host; on the CPU, 0 is one rank);
    ``num_processes`` hosts each start ``dp / num_processes`` of them and
    meet at ``coordinator_address``; ``process_id`` -1 reads the host's
    index from ``GROUP_RANK`` or ``NODE_RANK``."""
    hosts = max(1, dist_cfg.num_processes)
    addr = dist_cfg.coordinator_address
    if hosts > 1 and not addr:
        raise ValueError(f"dist.num_processes={hosts} needs "
                         "dist.coordinator_address (host:port of process 0)")
    pid = dist_cfg.process_id
    if hosts > 1 and pid < 0:
        found = [os.environ[k] for k in _ENV_RANK if k in os.environ]
        if not found:
            raise ValueError(
                "dist.process_id=-1 takes the host's index from "
                f"{' or '.join(_ENV_RANK)}, and neither is set: set "
                "dist.process_id")
        pid = int(found[0])
    if not 0 <= max(pid, 0) < hosts:
        raise ValueError(f"dist.process_id={pid} outside [0, {hosts})")
    devices = visible_devices(device_type)
    if dist_cfg.dp > 0:
        if dist_cfg.dp % hosts:
            raise ValueError(f"dist.dp={dist_cfg.dp} not divisible by "
                             f"dist.num_processes={hosts}")
        local = mesh_size(dist_cfg.dp // hosts, devices)
    else:
        local = mesh_size(0, devices if device_type == "cuda" else 1)
    world = local * hosts
    return Plan(world=world, local=local, first_rank=max(pid, 0) * local,
                device_type=device_type,
                init_method=f"tcp://{addr}" if addr else None)


def active() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def launcher_pid() -> int | None:
    """The launching process of this rank (None outside ``launch``)."""
    return _launcher


def shard(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """This rank's contiguous slice of a global tensor along ``axis``."""
    n = world_size()
    if n == 1:
        return x
    k = x.shape[axis] // n
    return x.narrow(axis, rank() * k, k).contiguous()


def shard_tree(tree, axis: int = 0):
    """``shard`` over a step's draws (dicts, lists, tuples, None): batch
    axis ``axis``, 1 for the ``TIME_MAJOR`` draws."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return shard(tree, axis)
    if isinstance(tree, dict):
        return {k: shard_tree(v, 1 if k in TIME_MAJOR else axis)
                for k, v in tree.items()}
    return type(tree)(shard_tree(v, axis) for v in tree)


def all_reduce_grads(grads) -> list[torch.Tensor]:
    """The ranks' mean of each gradient: one flat buffer in the given
    (parameter) order, summed over the ranks, divided by their number."""
    grads = list(grads)
    if not active():
        return grads
    if len({g.dtype for g in grads}) > 1:
        raise TypeError("all_reduce_grads takes gradients of one dtype")
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    collectives["all_reduce_grads"] += 1
    flat.div_(dist.get_world_size())
    return [part.view_as(g) for part, g in
            zip(flat.split([g.numel() for g in grads]), grads)]


class _GlobalSum(torch.autograd.Function):
    """Sum over the ranks; its backward is the same sum (differentiable
    again, for a double backward)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        collectives["global_sum"] += 1
        return y

    @staticmethod
    def backward(ctx, g):
        return _GlobalSum.apply(g)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, differentiably: each rank's local loss
    that uses it then gets the whole batch's gradient, and the averaged
    parameter gradients are the global function's."""
    return _GlobalSum.apply(x) if active() else x


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The global batch's mean of per-sample ``x`` (equal shards): the
    ranks' means summed, over their number (``x.mean()`` outside a
    group)."""
    if not active():
        return x.mean()
    return global_sum(x.mean()) / dist.get_world_size()


def global_var(x: torch.Tensor) -> torch.Tensor:
    """The population variance over axis 0 of the ranks' concatenated
    batch (equal shards), two-pass as ``jnp.var``: the mean from the
    shards' sums, then the squared deviations' sums, each a
    ``global_sum`` over N = the local batch x the world size.  In one
    rank (a group of one, or none) it is ``x.var(0, unbiased=False)``, the
    single-process bits.  Every rank must call it at the same point: its
    two all-reduces (and their twins in each backward) pair across the
    ranks in call order."""
    n = world_size()
    if n == 1:
        return x.var(dim=0, unbiased=False)
    count = x.shape[0] * n
    mean = global_sum(x.sum(dim=0)) / count
    return global_sum((x - mean).square().sum(dim=0)) / count


def reduce_for_log(metrics: dict, counts: torch.Tensor):
    """(``metrics`` with each tensor the ranks' mean, ``counts`` summed over
    the ranks), in one collective: a log point's reduction."""
    if not active():
        return metrics, counts
    names = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    buf = torch.cat([counts.float().reshape(-1)]
                    + [metrics[k].detach().float().reshape(1)
                       for k in names])
    dist.all_reduce(buf)
    collectives["reduce_for_log"] += 1
    means = buf[counts.numel():] / dist.get_world_size()
    return ({**metrics, **dict(zip(names, means.unbind()))},
            buf[:counts.numel()])


def any_rank(flag: bool) -> bool:
    """Whether ``flag`` holds on some rank, agreed on the host."""
    if not active():
        return flag
    t = torch.tensor([int(flag)])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_host_group)
    return bool(t.item())


def barrier() -> None:
    if active():
        dist.barrier(group=_host_group)


def same_on_every_rank(tensors: dict) -> list[str]:
    """The names of ``tensors`` whose bits differ between ranks (a
    fingerprint a tensor, its 32-bit words summed, compared by MIN / MAX
    over the ranks)."""
    if not active() or not tensors:
        return []
    names = sorted(tensors)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    prints = torch.stack([
        tensors[k].detach().float().contiguous().view(torch.int32)
        .to(torch.int64).sum().to(dev) for k in names])
    lo, hi = prints.clone(), prints
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    return [k for k, d in zip(names, (lo != hi).tolist()) if d]


def _join(plan: Plan, local_rank: int, init_method: str,
          threads: int | None = None) -> None:
    """Join the group as ``local_rank``; on the CPU with ``threads``
    intra-op threads (default: this process's share of its cores)."""
    global _host_group
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    kw = {}
    if plan.device_type == "cuda":
        torch.cuda.set_device(local_rank)       # before any kernel loads
        kw["device_id"] = torch.device("cuda", local_rank)
    else:   # the host's cores shared between its ranks
        torch.set_num_threads(
            threads or max(1, torch.get_num_threads() // plan.local))
    dist.init_process_group(
        "nccl" if plan.device_type == "cuda" else "gloo",
        init_method=init_method, world_size=plan.world,
        rank=plan.first_rank + local_rank, timeout=timeout, **kw)
    _host_group = (dist.new_group(backend="gloo", timeout=timeout)
                   if plan.device_type == "cuda" else dist.group.WORLD)


def join_from_env(device_type: str) -> None:
    """Join the group of a launcher that started this process (torchrun's
    ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``)."""
    local = int(os.environ["LOCAL_RANK"])
    world = int(os.environ["WORLD_SIZE"])
    rank_ = int(os.environ["RANK"])
    _join(Plan(world=world, local=1, first_rank=rank_ - local,
               device_type=device_type), local, "env://")


def launched() -> bool:
    """Whether this process is a rank already (of ``launch`` or of a
    launcher's environment)."""
    return active() or all(k in os.environ for k in
                           ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                            "MASTER_ADDR"))


def _worker(local_rank, fn, args, kwargs, plan, init_method, out_dir,
            parent, threads):
    global _launcher
    _launcher = parent
    _join(plan, local_rank, init_method, threads)
    try:
        result = fn(*args, **kwargs)
        with open(os.path.join(out_dir, f"result_{local_rank}.pkl"),
                  "wb") as fh:
            pickle.dump(result, fh)
    finally:
        dist.destroy_process_group()


def launch(fn, args: tuple, kwargs: dict, plan: Plan,
           timeout: float | None = None) -> list:
    """Run ``fn(*args, **kwargs)`` on each of this process's ``plan.local``
    ranks; returns their results in local-rank order.  A rank that fails
    stops the others and raises here.  SIGTERM / SIGINT (main thread) are
    forwarded to the ranks as SIGTERM; a second one kills them and is
    re-raised.  ``timeout`` (seconds, None: none) is the launch's deadline:
    past it the ranks still alive are killed and ``TimeoutError`` names
    them.  CPU ranks share this process's intra-op threads."""
    import torch.multiprocessing as mp

    deadline = None if timeout is None else time.monotonic() + timeout
    work = tempfile.mkdtemp(prefix="levelgan_torch_dp_")
    init = plan.init_method or "file://" + os.path.join(work, "store")
    threads = max(1, torch.get_num_threads() // plan.local)
    ctx = mp.start_processes(
        _worker, args=(fn, args, kwargs, plan, init, work, os.getpid(),
                       threads),
        nprocs=plan.local, join=False, start_method="spawn")
    old, hits = {}, []

    def forward(signum, frame):
        hits.append(signum)
        for p in ctx.processes:
            if p.is_alive():
                os.kill(p.pid, signal.SIGTERM if len(hits) == 1
                        else signal.SIGKILL)
        if len(hits) > 1:
            for s, h in old.items():
                signal.signal(s, h)
            signal.raise_signal(signum)

    if threading.current_thread() is threading.main_thread():
        for s in (signal.SIGTERM, signal.SIGINT):
            old[s] = signal.signal(s, forward)
    try:
        while not ctx.join(timeout=1.0, grace_period=5.0):
            if deadline is not None and time.monotonic() > deadline:
                alive = [plan.first_rank + i
                         for i, p in enumerate(ctx.processes)
                         if p.is_alive()]
                raise TimeoutError(
                    f"ranks {alive} still running {timeout:g} s after "
                    "their launch; killed")
        out = []
        for i in range(plan.local):
            with open(os.path.join(work, f"result_{i}.pkl"), "rb") as fh:
                out.append(pickle.load(fh))     # written by our own ranks
        return out
    finally:
        for s, h in old.items():
            signal.signal(s, h)
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(work, ignore_errors=True)
