"""Tensor-parallel process groups on ``torch.distributed``: one process a
rank (the port's counterpart of ``repro/distributed/__init__.py`` and of
the role ``repro/launch/mesh.py`` plays for a ``(1, N)`` serving mesh).

A ``TPGroup`` holds a rank's place in the group, the process group its
device collectives run on and a CPU gloo group for host decisions. The
backend of the device group is the caller's: ``"nccl"`` (one card a
rank) or ``"gloo"`` (the CPU, or several ranks on one card, where NCCL
refuses a second rank on a device); nothing picks it from what it finds.
A ``world == 1`` group is the identity and touches no process group.

The device collectives are ``all_reduce_sum``, the model's reduce points'
one operation (``distributed/sharding.py`` ``tp_reduce``), and, for a
sequence-sharded cache (``distributed/decode.py``), ``all_gather`` (a
decode step's partial states) and ``broadcast`` (a shard's live prefix
for the chunked prefill). Each counts its calls and bytes apart, the
fidelity probe's reduces (``probing``) apart as well. On gloo the
gather goes through the host: gloo gathers CPU tensors only. The host ones
keep every rank's scheduler in step: ``broadcast_host`` and ``host_clock`` hand rank 0's object or clock
reading to every rank, and ``check_agree`` compares a digest across the
ranks with one MIN and one MAX all-reduce, raising ``TPDivergence`` on a
mismatch rather than leaving the ranks to hang in the next collective.

``launch`` starts the ranks with the ``spawn`` start method and a
``file://`` rendezvous (no TCP port to clash between test processes),
runs ``fn(group, *args)`` in each and returns their results in rank
order; under ``torchrun`` (``RANK`` / ``WORLD_SIZE`` set) it runs this
process's rank in place. A rank that raises or dies fails the launch:
the other ranks are terminated and ``RuntimeError`` carries the
traceback.
"""
from __future__ import annotations

import datetime
import hashlib
import multiprocessing as mp
import os
import queue as queue_mod
import shutil
import tempfile
import traceback
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device

BACKENDS = ("nccl", "gloo")
# a collective that waits longer than this raises (the process group's
# timeout): a rank that diverged fails the run instead of hanging it
DEFAULT_TIMEOUT_S = 600.0


class TPDivergence(RuntimeError):
    """The ranks of a tensor-parallel group took different host
    decisions."""


@dataclass(eq=False)
class TPGroup:
    """One rank's view of a tensor-parallel group of ``world`` ranks."""
    rank: int
    world: int
    backend: Optional[str]
    device: torch.device
    group: Any = None      # device collectives (None when world == 1)
    cpu_group: Any = None  # gloo, host decisions (None when world == 1)
    reduce_calls: int = 0  # all_reduce_sum calls since reset_counts
    reduce_bytes: int = 0  # and the bytes they reduced
    probe_calls: int = 0   # the fidelity probe's calls (``probing``),
    probe_bytes: int = 0   # counted apart from the two above
    gather_calls: int = 0  # all_gather calls since reset_counts
    gather_bytes: int = 0  # and the bytes each rank sent
    bcast_calls: int = 0   # broadcast calls since reset_counts
    bcast_bytes: int = 0   # and the bytes they carried
    _probing: bool = False

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the ranks, in place; ``x`` itself at world 1."""
        if self.world == 1:
            return x
        if self._probing:
            self.probe_calls += 1
            self.probe_bytes += x.numel() * x.element_size()
        else:
            self.reduce_calls += 1
            self.reduce_bytes += x.numel() * x.element_size()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` stacked in rank order, (world, *x.shape) on
        x's device; ``x[None]`` at world 1. One collective of
        ``x.nbytes`` a rank."""
        if self.world == 1:
            return x[None]
        self.gather_calls += 1
        self.gather_bytes += x.numel() * x.element_size()
        x = x.contiguous()
        if self.backend == "gloo":  # gloo gathers host tensors only
            src = x.cpu()
            parts = [torch.empty_like(src) for _ in range(self.world)]
            dist.all_gather(parts, src, group=self.group)
            return torch.stack(parts).to(x.device)
        out = torch.empty((self.world, *x.shape), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, x, group=self.group)
        return out

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """Rank ``src``'s ``x`` into every rank's ``x`` (contiguous, of
        the same shape and dtype everywhere), in place; ``x`` itself at
        world 1."""
        if self.world == 1:
            return x
        self.bcast_calls += 1
        self.bcast_bytes += x.numel() * x.element_size()
        dist.broadcast(x, src=src, group=self.group)
        return x

    @contextmanager
    def probing(self):
        """Count the reduces inside the block as the fidelity probe's."""
        prev, self._probing = self._probing, True
        try:
            yield
        finally:
            self._probing = prev

    def reset_counts(self) -> None:
        self.reduce_calls = self.reduce_bytes = 0
        self.probe_calls = self.probe_bytes = 0
        self.gather_calls = self.gather_bytes = 0
        self.bcast_calls = self.bcast_bytes = 0

    def broadcast_host(self, obj: Any) -> Any:
        """Rank 0's ``obj`` on every rank (a picklable host object)."""
        if self.world == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.cpu_group)
        return box[0]

    def host_clock(self, clock: Callable[[], float]) -> Callable[[], float]:
        """``clock`` read on rank 0 and broadcast: every rank sees the same
        time, so deadlines, aging and arrivals decide alike. Each call is
        a collective, so every rank must call it as often."""
        if self.world == 1:
            return clock

        def shared() -> float:
            t = torch.tensor([clock() if self.rank == 0 else 0.0],
                             dtype=torch.float64)
            dist.broadcast(t, src=0, group=self.cpu_group)
            return float(t[0])
        return shared

    def check_agree(self, digest: int, what: str) -> None:
        """Raise ``TPDivergence`` naming ``what`` unless every rank holds
        the same ``digest`` (a signed 64-bit int)."""
        if self.world == 1:
            return
        lo = torch.tensor([digest], dtype=torch.int64)
        hi = lo.clone()
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=self.cpu_group)
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=self.cpu_group)
        if int(lo[0]) != int(hi[0]):
            raise TPDivergence(
                f"{what}: the {self.world} tensor-parallel ranks disagree "
                f"(rank {self.rank} digest {digest}, min {int(lo[0])}, "
                f"max {int(hi[0])}): every rank must see the same "
                f"submissions and take the same host decisions")

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier(group=self.cpu_group)

    def mesh_shape(self) -> Tuple[int, int]:
        """The JAX serving mesh this group stands for: (1, world)."""
        return (1, self.world)


def digest(*parts: Any) -> int:
    """A signed 64-bit digest of ``repr(parts)``, the same in every
    process (Python's ``hash`` of a string is salted per process)."""
    h = hashlib.blake2b(repr(parts).encode(), digest_size=8).digest()
    return int.from_bytes(h, "little", signed=True)


def init_tp(world: int = 1, rank: int = 0, backend: Optional[str] = None,
            init_method: Optional[str] = None, device=None,
            timeout: float = DEFAULT_TIMEOUT_S) -> TPGroup:
    """Join a tensor-parallel group of ``world`` ranks as ``rank`` over
    ``backend`` ("nccl" or "gloo"), rendezvousing at ``init_method``
    (``file://...``, ``tcp://...`` or ``env://``). ``device`` is the
    rank's device; a bare "cuda" means card ``rank % device_count``.
    ``timeout`` seconds bound every collective. World 1 builds no
    process group."""
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"init_tp: rank {rank} of world {world}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    if world == 1:
        return TPGroup(rank=0, world=1, backend=backend, device=dev)
    if backend not in BACKENDS:
        raise ValueError(f"init_tp: backend={backend!r}; name one of "
                         f"{BACKENDS}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("init_tp: the nccl backend runs on cuda devices; "
                         "use gloo on the CPU")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    td = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, timeout=td)
    cpu = dist.new_group(backend="gloo", timeout=td)
    return TPGroup(rank=rank, world=world, backend=backend, device=dev,
                   group=dist.group.WORLD, cpu_group=cpu)


def close_tp(group: TPGroup) -> None:
    if group.world > 1 and dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(rank: int, world: int, backend: str, init_method: str,
               device, timeout: float, fn: Callable, args: Sequence,
               results) -> None:
    """A spawned rank: join the group, run ``fn``, report to the parent."""
    group = None
    try:
        group = init_tp(world, rank, backend, init_method, device, timeout)
        out = fn(group, *args)
        results.put((rank, True, out))
    except Exception:  # reported; the parent fails the launch
        results.put((rank, False, traceback.format_exc()))
    finally:
        if group is not None:
            close_tp(group)


def launch(fn: Callable, world: int, backend: str, *, args: Sequence = (),
           init_method: Optional[str] = None, device=None,
           timeout: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """Run ``fn(group, *args)`` on ``world`` ranks and return their
    results in rank order (picklable host objects). ``fn`` must be a
    module-level function (the ``spawn`` start method imports it).
    Without ``init_method`` the ranks meet at a ``file://`` path in a
    fresh temporary directory. Under ``torchrun`` this process runs its
    own rank (``env://``) and the other ranks' entries are None."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        group = init_tp(world, rank, backend, "env://", device, timeout)
        try:
            out = [None] * world
            out[rank] = fn(group, *args)
            return out
        finally:
            close_tp(group)
    if world == 1:
        return [fn(init_tp(1, 0, backend, None, device, timeout), *args)]
    tmp = None
    if init_method is None:
        tmp = tempfile.mkdtemp(prefix="tp-rendezvous-")
        init_method = "file://" + os.path.join(tmp, "store")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, backend, init_method, device,
                               timeout, fn, tuple(args), results),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    out: List[Any] = [None] * world
    got, failures = set(), []
    try:
        while len(got) < world and not failures:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue_mod.Empty:
                failures = [f"rank {r} exited with code {p.exitcode} "
                            f"before reporting"
                            for r, p in enumerate(procs)
                            if r not in got and p.exitcode not in (None, 0)]
                continue
            got.add(rank)
            if ok:
                out[rank] = payload
            else:
                failures.append(f"rank {rank} raised:\n{payload}")
    finally:
        if failures:
            for p in procs:
                if p.is_alive():
                    p.terminate()
        for p in procs:
            p.join()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    if failures:
        raise RuntimeError(f"tensor-parallel launch of {world} ranks over "
                           f"{backend} failed: " + "\n".join(failures))
    return out
