"""Data parallelism over torch.distributed ranks (counterpart of
mirres_restir_nerf_mesh_tpu/parallel/mesh.py).

The JAX package shards the ray / pixel batch over a device mesh and lets
XLA insert the collectives.  Here each rank is a process with one device:
every rank holds the whole (replicated) state, draws the whole step's
randoms from the same seed and takes its contiguous rows of the batch
(``shard_rows``); the step's gradients are summed over the ranks
(``all_reduce_grads``), so Adam and the EMA run on identical numbers on
every rank.  The parameters are NamedTuples of tensors with a functional
Adam, not ``nn.Module``s, so the gradient sync is this explicit all-reduce.

- ``init_data_parallel`` joins a process group (torchrun's ``RANK`` /
  ``WORLD_SIZE`` / ``LOCAL_RANK`` unless given) -> ``DataParallel``.
- ``launch`` spawns one process a rank, runs ``fn(dp, *args)`` in each
  and returns their results; any rank's failure raises.
- ``gather_rows`` is the differentiable all-gather of row shards (its
  backward sums the gradient over the ranks and keeps the caller's rows);
  ``all_reduce_sum`` the differentiable sum (its backward is a sum too);
  ``global_mean`` the one-device mean of a sharded tensor through it.

Under gloo, a collective on CUDA tensors is staged through pinned host
memory; NCCL takes the tensors on the rank's card.  ``all_reduce.bytes`` and
``all_gather_rows.bytes`` count the bytes of the buffers this process
summed (gradients included) and of the tensors it gathered, ``.seconds``
the host time from the staged buffer to the result back on the device
(under gloo the collective and the copy back; under NCCL the launch
alone); the caller zeroes them.
"""

from __future__ import annotations

import os
import queue
import socket
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device


@dataclass(frozen=True)
class DataParallel:
    """One rank's view of the process group."""

    group: Any                   # the torch.distributed process group
    rank: int
    world: int
    device: torch.device         # this rank's device
    backend: str                 # "nccl" or "gloo"


def init_data_parallel(device="cuda", backend: Optional[str] = None,
                       init_method: str = "env://", rank: Optional[int] = None,
                       world: Optional[int] = None,
                       local_rank: Optional[int] = None) -> DataParallel:
    """Join the process group -> DataParallel.  Rank, world and local rank
    default to torchrun's RANK, WORLD_SIZE and LOCAL_RANK; a CUDA device
    becomes ``cuda:LOCAL_RANK`` unless it names an index; the backend
    defaults to NCCL on the card and gloo on the CPU.  A failed init
    raises: there is no single-process fallback."""
    rank = int(os.environ["RANK"]) if rank is None else rank
    world = int(os.environ["WORLD_SIZE"]) if world is None else world
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    return DataParallel(group=dist.group.WORLD, rank=dist.get_rank(),
                        world=dist.get_world_size(), device=dev, backend=dist.get_backend())


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, backend, device, init_method, args, results) -> None:
    try:
        dp = init_data_parallel(device, backend, init_method, rank, world, local_rank=rank)
        out = fn(dp, *args)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    dist.destroy_process_group()


def launch(fn: Callable, nprocs: int, backend: str = "nccl",
           device_of_rank: Optional[Callable[[int], Any]] = None,
           init_method: Optional[str] = None, args: Sequence = (),
           timeout: Optional[float] = None) -> List[Any]:
    """Spawn ``nprocs`` ranks; rank r joins the group on
    ``device_of_rank(r)`` (default ``cuda:r``) and runs ``fn(dp, *args)``.
    -> the ranks' return values in rank order.  ``fn`` and its arguments
    and results are pickled (``fn`` by import path).  ``init_method``
    defaults to a free localhost TCP port.  A rank that raises or dies,
    or a run past ``timeout`` seconds, ends every rank and raises."""
    import multiprocessing as mp

    devices = [str(device_of_rank(r)) if device_of_rank is not None else f"cuda:{r}"
               for r in range(nprocs)]
    init_method = init_method or f"tcp://localhost:{free_port()}"
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, nprocs, backend, devices[r],
                                                  init_method, tuple(args), results))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    got, errors = {}, []
    t_end = None if timeout is None else time.monotonic() + timeout
    try:
        while len(got) < nprocs and not errors:
            try:
                rank, ok, val = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if dead:
                    errors.append(f"rank {dead[0]} exited with code {procs[dead[0]].exitcode}")
                elif t_end is not None and time.monotonic() > t_end:
                    errors.append(f"ranks still running after {timeout} s")
                continue
            if ok:
                got[rank] = val
            else:
                errors.append(f"rank {rank} failed:\n{val}")
    finally:
        for p in procs:
            if errors and p.is_alive():
                p.terminate()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("data-parallel launch failed: " + errors[0])
    return [got[r] for r in range(nprocs)]


# ----------------------------------------------------------------- shards
def shard_rows(n: int, rank: int, world: int) -> Tuple[int, int]:
    """Rank's contiguous rows [lo, hi) of n: the first n % world ranks take
    one row more."""
    base, extra = divmod(n, world)
    lo = rank * base + min(rank, extra)
    return lo, lo + base + (1 if rank < extra else 0)


class Shard(NamedTuple):
    """This rank's rows [lo, hi) of n; ``counts``: every rank's row count."""

    dp: DataParallel
    lo: int
    hi: int
    n: int
    counts: Tuple[int, ...]

    def scaled(self, k: int) -> "Shard":
        """The same shard in units of k elements a row (pixels of image rows)."""
        return Shard(self.dp, self.lo * k, self.hi * k, self.n * k,
                     tuple(c * k for c in self.counts))


def shard_of(n: int, dp: DataParallel) -> Shard:
    """This rank's rows of n (every rank must get at least one)."""
    if n < dp.world:
        raise ValueError(f"{n} rows cannot be sharded over {dp.world} ranks")
    counts = tuple(b - a for a, b in (shard_rows(n, r, dp.world) for r in range(dp.world)))
    return Shard(dp, *shard_rows(n, dp.rank, dp.world), n, counts)


def barrier(dp: DataParallel) -> None:
    """Wait for every rank (a one-element all-reduce, on either backend)."""
    all_reduce(torch.zeros((1,), device=dp.device), dp)


# ------------------------------------------------------------ collectives
def _to_comm(x: torch.Tensor, dp: DataParallel) -> torch.Tensor:
    """A fresh buffer the backend takes: on the rank's card for NCCL, on
    the host (pinned when x is on a card) for gloo; bool as uint8."""
    x = x.detach()
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    if dp.backend == "nccl":
        return x.to(dp.device, copy=True).contiguous()
    if x.is_cuda:
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        return h.copy_(x)
    return x.clone(memory_format=torch.contiguous_format)


def _from_comm(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return buf.to(device=like.device, dtype=like.dtype)


def all_reduce(x: torch.Tensor, dp: DataParallel) -> torch.Tensor:
    """Sum of x over the ranks (a new tensor; no gradient)."""
    buf = _to_comm(x, dp)
    t0 = time.perf_counter()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=dp.group)
    out = _from_comm(buf, x)
    all_reduce.bytes += buf.numel() * buf.element_size()
    all_reduce.seconds += time.perf_counter() - t0
    return out


def _flat_apply(tensors: Sequence[torch.Tensor], dp: DataParallel, op,
                counter=None) -> List[torch.Tensor]:
    """op on one flattened buffer per (dtype, device), in first-appearance
    order -> new tensors of the inputs' shapes; counter: the function whose
    bytes / seconds count the op."""
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.dtype, t.device), []).append(i)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for idx in groups.values():
        like = tensors[idx[0]]
        buf = _to_comm(torch.cat([tensors[i].detach().reshape(-1) for i in idx]), dp)
        t0 = time.perf_counter()
        op(buf)
        flat = _from_comm(buf, like)
        if counter is not None:
            counter.bytes += buf.numel() * buf.element_size()
            counter.seconds += time.perf_counter() - t0
        for i, part in zip(idx, torch.split(flat, [tensors[i].numel() for i in idx])):
            out[i] = part.reshape(tensors[i].shape)
    return out


def replicate(leaves: Sequence[torch.Tensor], dp: DataParallel) -> List[torch.Tensor]:
    """Rank 0's values of every leaf, on every rank."""
    return _flat_apply(leaves, dp, lambda b: dist.broadcast(b, src=0, group=dp.group))


def all_reduce_grads(grads: Sequence[Optional[torch.Tensor]], leaves: Sequence[torch.Tensor],
                     dp: DataParallel) -> List[torch.Tensor]:
    """Gradients summed over the ranks, one flattened buffer per dtype; a
    None gradient (the leaf unused) counts as zeros of its leaf."""
    full = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
    return _flat_apply(full, dp, lambda b: dist.all_reduce(b, group=dp.group), all_reduce)


def all_reduce_scalars(values: dict, dp: DataParallel) -> dict:
    """{name: scalar} summed over the ranks, in float64 -> {name: float64
    0-d CPU tensor}."""
    keys = list(values)
    buf = torch.tensor([float(values[k]) for k in keys], dtype=torch.float64)
    summed = all_reduce(buf, dp).cpu()
    return {k: summed[i] for i, k in enumerate(keys)}


def all_gather_rows(x: torch.Tensor, dp: DataParallel,
                    counts: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Every rank's rows of x, in rank order (no gradient).  counts: the
    rows of each rank (gathered first when None); shards may be uneven."""
    if counts is None:
        c = all_gather_rows(torch.tensor([x.shape[0]], dtype=torch.int64), dp, [1] * dp.world)
        counts = [int(v) for v in c]
    buf = _to_comm(x, dp)
    m = max(counts)
    if buf.shape[0] < m:
        buf = torch.cat([buf, buf.new_zeros((m - buf.shape[0],) + tuple(buf.shape[1:]))])
    parts = [torch.empty_like(buf) for _ in range(dp.world)]
    t0 = time.perf_counter()
    dist.all_gather(parts, buf, group=dp.group)
    out = torch.cat([p[:c] for p, c in zip(parts, counts)])
    res = _from_comm(out, x)
    all_gather_rows.bytes += out.numel() * out.element_size()
    all_gather_rows.seconds += time.perf_counter() - t0
    return res


all_reduce.bytes = all_reduce.seconds = 0
all_gather_rows.bytes = all_gather_rows.seconds = 0


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dp, counts):
        ctx.dp = dp
        ctx.lo = sum(counts[:dp.rank])
        ctx.n = x.shape[0]
        return all_gather_rows(x, dp, counts)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g, ctx.dp)
        return g[ctx.lo:ctx.lo + ctx.n], None, None


def gather_rows(x: torch.Tensor, dp: DataParallel, counts: Sequence[int]) -> torch.Tensor:
    """The all-gather of the ranks' row shards of x (``counts`` rows each,
    in rank order).  Its gradient sums the full tensor's gradient over the
    ranks and keeps this rank's rows, so a loss that reads other ranks'
    rows sends their gradient back to the rank that owns them."""
    return _GatherRows.apply(x, dp, list(counts))


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dp):
        ctx.dp = dp
        return all_reduce(x, dp)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.dp), None


def all_reduce_sum(x: torch.Tensor, dp: DataParallel) -> torch.Tensor:
    """The sum of x over the ranks, the same on every rank; its gradient is
    the sum of the ranks' gradients (each rank computes the same loss of
    it and back-propagates 1/R of that loss)."""
    return _AllReduceSum.apply(x, dp)


def global_mean(x: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """The mean of x over every rank, equal on every rank and
    differentiable; x holds a whole number of elements for each of the
    shard's local rows.  torch.mean without a shard."""
    if shard is None:
        return torch.mean(x)
    total = x.numel() // (shard.hi - shard.lo) * shard.n
    return all_reduce_sum(x.sum(), shard.dp) / float(total)


# ----------------------------------------------------------------- checks
def checksum(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """A position-weighted sum of every leaf's bytes (int64 [len(leaves)]):
    equal bits give equal sums."""
    out = []
    for x in leaves:
        b = x.detach().contiguous().reshape(-1).view(torch.uint8).to(torch.int64)
        w = torch.arange(b.numel(), device=b.device) % 65521 + 1
        out.append((b * w).sum().cpu())
    return torch.stack(out) if out else torch.zeros((0,), dtype=torch.int64)


def same_on_all_ranks(leaves: Sequence[torch.Tensor], dp: DataParallel) -> bool:
    """Every rank holds the same bits in every leaf (gathered checksums)."""
    c = checksum(leaves)
    g = all_gather_rows(c[None], dp, [1] * dp.world)
    return bool((g == g[0:1]).all())
