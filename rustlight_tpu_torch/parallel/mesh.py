"""A device mesh as torch.distributed ranks, one process a device.

The JAX package renders over a mesh with `shard_map`: one controller, the
devices' shards, `psum` and collective-permute lowered by XLA. Here every
device is a process of its own (a rank), each with its own host loop, and
the collectives are plain functions over a process group: gloo on the CPU
(or for ranks that share one card), NCCL across cards.

  - `run_on_mesh(n, fn, *args)` spawns n ranks, calls `fn(mesh, *args)` on
    each and returns rank 0's result. The ranks meet through a `file://`
    store in a fresh temporary directory; the process group has a timeout
    and the call a deadline, past which the ranks are killed and the call
    raises, as it does as soon as one rank raises or dies.
  - `gather_rows`: the all-gather of row shards in rank order (the concat
    of `P("d", ...)` shards), uneven shards included.
  - `sum_over_ranks`: the psum, as an all-gather followed by a sum in rank
    order, so that the result repeats bit for bit on every rank and every
    backend.
  - `halo_rows(mesh, x, k)`: `torch.roll(x, k, 0)` of the row-banded global
    array, which sends only the |k| boundary rows to each neighbour.
  - `agree(mesh, value)`: rank 0's value on every rank (a stop decision).

gloo's point-to-point ops take CPU tensors only, so under gloo every
collective stages a CUDA tensor through the host. A Mesh counts what its
collectives do: `moved` (elements this rank sent to others), `staged`
(bytes copied through the host), `coll_s` and `stage_s` (seconds in the
collectives and in their staging).
"""
from __future__ import annotations

import os
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

# the mesh of the calling rank, set by run_on_mesh's rank main
_CURRENT: Optional["Mesh"] = None
DEFAULT_TIMEOUT_S = 900.0


class Mesh:
    """One rank's view of the mesh: `rank` of `size`, its `device`, the
    process `group` and its `backend`. Without a process group a Mesh is a
    view of shard `rank` alone: its collectives return their input, so
    that one process can render each shard and check the ranks' result
    (a mesh of one is such a view)."""

    def __init__(self, rank: int = 0, size: int = 1, device="cpu",
                 group=None, backend: Optional[str] = None):
        self.rank = int(rank)
        self.size = int(size)
        self.device = torch.device(device)
        self.group = group
        self.backend = backend
        self.reset_counts()

    def reset_counts(self) -> None:
        self.moved = 0
        self.staged = 0
        self.coll_s = 0.0
        self.stage_s = 0.0
        self.calls = 0

    @property
    def distributed(self) -> bool:
        """Whether the collectives talk to other ranks."""
        return self.size > 1 and self.group is not None

    def bands(self, n: int) -> List[Tuple[int, int]]:
        """Every rank's rows [lo, hi) of n rows, as np.array_split gives
        them (the first n % size bands one row longer)."""
        cuts = np.cumsum([0] + [len(b) for b in np.array_split(
            np.arange(n), self.size)])
        return [(int(cuts[r]), int(cuts[r + 1])) for r in range(self.size)]

    def band(self, n: int) -> Tuple[int, int]:
        """This rank's rows [lo, hi) of n rows."""
        return self.bands(n)[self.rank]

    def shard(self, n: int) -> Tuple[int, int]:
        """This rank's lanes of n lanes (n a multiple of size): shard d
        holds [d * n / size, (d + 1) * n / size)."""
        if n % self.size:
            raise ValueError(f"{n} lanes do not split over {self.size} ranks")
        per = n // self.size
        return self.rank * per, (self.rank + 1) * per

    def __repr__(self) -> str:
        return (f"Mesh(rank={self.rank}, size={self.size}, "
                f"device={self.device}, backend={self.backend})")


def _card_or_raise(what: str) -> None:
    """No silent fall back to the CPU: a card asked for must be there."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what}: torch.cuda.is_available() is false; "
                           "name the CPU (device='cpu') to run there")


def make_device_mesh(n_devices: Optional[int] = None,
                     device="cuda") -> Mesh:
    """The calling rank's mesh inside run_on_mesh; elsewhere a mesh of one
    device (`device`, the card by default) without a process group. A card
    asked for that is not there raises."""
    if _CURRENT is not None:
        if n_devices not in (None, _CURRENT.size):
            raise ValueError(f"a mesh of {n_devices} asked inside a mesh of "
                             f"{_CURRENT.size} ranks")
        return _CURRENT
    if n_devices not in (None, 1):
        raise ValueError("a mesh of more than one device needs run_on_mesh")
    if torch.device(device).type == "cuda":
        _card_or_raise("make_device_mesh")
    return Mesh(device=device)


# ---- the collectives


class _Timed:
    """Times a collective (synchronizing the card around it) into
    mesh.coll_s."""

    def __init__(self, mesh: Mesh, x: torch.Tensor):
        self.mesh, self.cuda = mesh, x.is_cuda

    def __enter__(self):
        if self.cuda:
            torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.synchronize()
        self.mesh.coll_s += time.perf_counter() - self.t0
        self.mesh.calls += 1


def _out(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """x as the backend takes it: contiguous, bool as uint8, on the host
    under gloo (staged) and on the rank's card under NCCL."""
    x = x.contiguous()
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    if mesh.backend == "gloo" and x.device.type != "cpu":
        t0 = time.perf_counter()
        x = x.cpu()
        mesh.stage_s += time.perf_counter() - t0
        mesh.staged += x.numel() * x.element_size()
    elif mesh.backend == "nccl" and x.device != mesh.device:
        x = x.to(mesh.device)
    return x


def _back(mesh: Mesh, y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """y on the device and of the dtype of `like` (the staging back)."""
    if y.device != like.device:
        t0 = time.perf_counter()
        y = y.to(like.device)
        if like.is_cuda:
            torch.cuda.synchronize()
            mesh.stage_s += time.perf_counter() - t0
            mesh.staged += y.numel() * y.element_size()
    return y.to(like.dtype)


def gather_rows(mesh: Mesh, x: torch.Tensor,
                counts: Optional[List[int]] = None) -> torch.Tensor:
    """Every rank's rows of x, concatenated in rank order on every rank.
    `counts` gives each rank's row count (by default exchanged first); the
    shards may be uneven."""
    if not mesh.distributed:
        return x
    with _Timed(mesh, x):
        xs = _out(mesh, x)
        if counts is None:
            n = torch.tensor([xs.shape[0]], dtype=torch.int64,
                             device=_coll_device(mesh))
            ns = [torch.zeros_like(n) for _ in range(mesh.size)]
            dist.all_gather(ns, n, group=mesh.group)
            counts = [int(v) for v in ns]
        top = max(counts)
        if xs.shape[0] < top:
            xs = torch.cat([xs, xs.new_zeros((top - xs.shape[0],)
                                             + tuple(xs.shape[1:]))])
        parts = [torch.empty_like(xs) for _ in range(mesh.size)]
        dist.all_gather(parts, xs, group=mesh.group)
        mesh.moved += xs.numel() * (mesh.size - 1)
        out = torch.cat([p[:c] for p, c in zip(parts, counts)])
        return _back(mesh, out, x)


def gather_axis(mesh: Mesh, x: torch.Tensor, axis: int,
                counts: Optional[List[int]] = None) -> torch.Tensor:
    """gather_rows along `axis`."""
    return gather_rows(mesh, x.movedim(axis, 0), counts).movedim(0, axis)


def sum_over_ranks(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's x on every rank: an all-gather, then the
    parts added left to right in rank order (the same bits everywhere)."""
    if not mesh.distributed:
        return x
    with _Timed(mesh, x):
        xs = _out(mesh, x)
        parts = [torch.empty_like(xs) for _ in range(mesh.size)]
        dist.all_gather(parts, xs, group=mesh.group)
        mesh.moved += xs.numel() * (mesh.size - 1)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return _back(mesh, out, x)


def halo_rows(mesh: Mesh, x: torch.Tensor, k: int) -> torch.Tensor:
    """torch.roll(X, k, 0) of the global array X whose row bands the ranks
    hold, in rank order (x this rank's band): out[i] = X[i - k], wrapping.
    Sends this rank's |k| boundary rows to the neighbour that needs them
    and receives as many; |k| must not exceed any band's rows."""
    if not mesh.distributed or k == 0:
        return torch.roll(x, k, 0)
    m = abs(k)
    if x.shape[0] < m:
        raise ValueError(f"a halo of {m} rows from a band of {x.shape[0]}")
    nxt = _peer(mesh, (mesh.rank + 1) % mesh.size)
    prv = _peer(mesh, (mesh.rank - 1) % mesh.size)
    with _Timed(mesh, x):
        # k > 0: the last k rows go to the next rank, the previous rank's
        # arrive in front; k < 0: the first |k| rows go to the previous
        # rank, the next rank's arrive behind
        send, to, frm = ((x[-m:], nxt, prv) if k > 0 else (x[:m], prv, nxt))
        send = _out(mesh, send)
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, to, group=mesh.group),
               dist.P2POp(dist.irecv, recv, frm, group=mesh.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        mesh.moved += send.numel()
        recv = _back(mesh, recv, x)
    return torch.cat([recv, x[:-m]] if k > 0 else [x[m:], recv])


def agree(mesh: Mesh, value: Any) -> Any:
    """Rank 0's `value` (any picklable object) on every rank."""
    if not mesh.distributed:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=_peer(mesh, 0), group=mesh.group)
    return box[0]


def gather_objects(mesh: Mesh, value: Any) -> List[Any]:
    """Every rank's `value` (picklable), in rank order, on every rank."""
    if not mesh.distributed:
        return [value]
    out = [None] * mesh.size
    dist.all_gather_object(out, value, group=mesh.group)
    return out


def _peer(mesh: Mesh, r: int) -> int:
    """The global rank of the mesh's rank r (a mesh may be a subgroup)."""
    if mesh.group is dist.group.WORLD:
        return r
    return dist.get_global_rank(mesh.group, r)


def _coll_device(mesh: Mesh) -> torch.device:
    return mesh.device if mesh.backend == "nccl" else torch.device("cpu")


# ---- the ranks


def _rank_main(rank, n, init, backend, device, timeout_s, threads, fn, args,
               results):
    global _CURRENT
    try:
        if threads is not None:
            torch.set_num_threads(threads)
        # the ranks meet on one host: the loopback device
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        if backend == "nccl":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        else:
            dev = torch.device(device or "cpu")
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=init, rank=rank,
                                world_size=n,
                                timeout=timedelta(seconds=timeout_s), **kw)
        _CURRENT = Mesh(rank, n, dev, dist.group.WORLD, backend)
        out = fn(_CURRENT, *args)
        dist.barrier()
        results.put(("ok", rank, out if rank == 0 else None))
    except BaseException:   # noqa: BLE001 (reported to the parent)
        results.put(("err", rank, traceback.format_exc()))
    finally:
        _CURRENT = None
        if dist.is_initialized():
            dist.destroy_process_group()


def default_backend(device=None) -> str:
    """NCCL where the ranks take a card each (no device named), gloo where
    every rank shares the named device. With no device named and no card
    present it raises: the CPU is used only where it is named."""
    if device is None:
        _card_or_raise("default_backend")
        return "nccl"
    return "gloo"


def run_on_mesh(n: int, fn: Callable, *args, backend: Optional[str] = None,
                device=None, timeout: float = DEFAULT_TIMEOUT_S,
                threads: Optional[int] = None):
    """Spawn n ranks, call fn(mesh, *args) on each (fn and args picklable:
    a module-level function) and return rank 0's result.

    Under NCCL rank r renders on cuda:r; under gloo every rank on `device`
    (the CPU by default, or one card that the ranks share). `threads` sets
    torch's CPU threads in each rank. A rank that raises or dies fails the
    call with its traceback; past `timeout` seconds (also the process
    group's timeout) the ranks are killed and the call raises
    TimeoutError."""
    backend = backend or default_backend(device)
    if backend == "nccl" and torch.cuda.device_count() < n:
        raise ValueError(f"NCCL over {n} ranks needs {n} cards "
                         f"({torch.cuda.device_count()} seen)")
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="rl_mesh_")
    init = "file://" + os.path.join(tmp, "store")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        r, n, init, backend, None if device is None else str(device),
        timeout, threads, fn, args, results)) for r in range(n)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        out, done = None, set()
        while len(done) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"run_on_mesh: {n - len(done)} of {n} "
                                   f"ranks still running after {timeout}s")
            try:
                kind, rank, val = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in done and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"run_on_mesh: rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode}") from None
                continue
            if kind == "err":
                raise RuntimeError(f"run_on_mesh: rank {rank} of {n} "
                                   f"failed:\n{val}")
            done.add(rank)
            if rank == 0:
                out = val
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
