"""The mesh: one thread per rank and a small collective group, over one
process or several.

Counterpart of the JAX package's ``parallel/mesh.py`` (``make_mesh`` :28,
``init_multihost`` :58, ``mesh_dp_axes`` :113, ``to_global`` :119,
``to_global_rows`` :138, ``pad_to_multiple`` :167). JAX runs one program
on every device of a ``jax.sharding.Mesh`` (``shard_map``) with
``psum``/``pmin``/``all_gather`` between them. PyTorch's own
single-process idiom for that is one thread per device
(``torch.nn.parallel.parallel_apply``): ``Mesh.run(fn)`` calls ``fn(comm)``
on one thread per rank, inside ``torch.cuda.device`` of the rank's card,
and returns every rank's output. Torch operations and the kernels' ctypes
calls release the interpreter lock, so the ranks' host work overlaps.

A mesh may name one device several times: ``make_mesh(devices=["cuda:0"]
* 4)`` runs four ranks on one card. That is how the cross-rank paths (the
partitioned target's halo exchange, the tie combine, the edge-sharded
Gauss-Newton) run on a machine with one card, as the JAX tests run them
on XLA's virtual host devices. Four ranks on one card measure
correctness and overhead, never scaling.

The group's contract:

* ``all_gather(x)`` returns every rank's ``x`` in rank order, each moved
  to the caller's device. ``psum`` is that gather followed by a left fold
  in rank order, ``((x0 + x1) + x2) + ...``, on every rank, so every rank
  holds the same bits and takes the same convergence decisions, whatever
  the threads' timing (the discipline the pose graph's dense incidence
  sums follow on one device). ``pmin``/``pmax`` are exact anyway.
* Every collective is entered by every rank, in the same order: each
  carries a sequence number and an operation name, and a mismatch raises.
  A branch that guards a collective must read a *reduced* value.
* A rank that raises, or returns while the others still wait in a
  collective, ends the run: the waiting ranks are released with an error
  at once, and ``Mesh.run`` re-raises the first failure naming its rank.
  A rank that never arrives breaks the wait after ``timeout`` seconds.
* ``Comm.tally`` counts per rank: ``bytes_sent`` (what the rank
  contributed to collectives, the counterpart of the HLO payload
  ``tests/test_sharded.py`` pins: 84 B per point-mode iteration, 188 B in
  plane mode, whatever the process layout), ``collectives``, and whatever
  a path adds (the partitioned target's repair passes and queries).
  ``Mesh.stats`` sums each rank's tallies over runs until
  ``Mesh.reset_stats()`` (this process's ranks only).

The first rank of the process runs in a copy of the caller's
``contextvars`` context, so a ``runtime.timing.collect`` block around a
mesh call records that rank's stages; the other ranks run in fresh
contexts and record none (a collector is not shared between threads).

Several processes (``init_multihost``): the ranks span the processes of
a ``torch.distributed`` group, each process running threads for its own
ranks only (``Mesh.local_ranks``), row-major as JAX orders
``jax.devices()`` by process. The contract above holds over the global
ranks. In each collective the process's own ranks deposit their items;
then the thread that called ``Mesh.run`` (the only thread that ever
calls ``torch.distributed``) all-gathers across the processes a small
int64 header per rank (status, sequence number, operation, shape, dtype)
and then the data, and every rank sees all contributions in global rank
order. So ``psum`` is the same left fold, and 2 processes × 2 ranks give
the bits of 1 process × 4 ranks. A header that differs between ranks
raises the collective-mismatch error naming both; a rank that fails is
reported in the next header exchange, so every process fails the run; a
peer process that dies, or a process-group call that fails or times out
(the group's ``timeout``), becomes ``RankFailed`` naming the lost process
and its ranks, and the caller exits instead of waiting. NCCL carries the
data between cards (one process per card); gloo carries it through host
memory, for the CPU and for several processes sharing one card (NCCL
refuses two ranks of one communicator on one GPU). ``to_global``,
``to_global_rows`` and ``process_allgather`` place and gather rows on
such a mesh.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import datetime
import os
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

DEFAULT_TIMEOUT = 600.0  # seconds a rank waits for the others
# Seconds a process-group call waits for the other processes before it
# fails (JAX's default heartbeat bound).
DEFAULT_PROCESS_TIMEOUT = 100

# PyTorch loads its CUDA linear-algebra library at the first such call in
# the process, and that lazy load is not thread-safe: a second rank
# thread inside it raises "lazy wrapper should be called at most once".
# ``Mesh.run`` makes one such call before any rank thread starts.
_LINALG_LOCK = threading.Lock()
_linalg_loaded = False


def _load_cuda_linalg(devices) -> None:
    global _linalg_loaded
    cards = [d for d in devices if d.type == "cuda"]
    if not cards:
        return
    with _LINALG_LOCK:
        if not _linalg_loaded:
            torch.linalg.solve_ex(torch.eye(3, device=cards[0]),
                                  torch.ones(3, device=cards[0]))
            _linalg_loaded = True


class RankFailed(RuntimeError):
    """A rank of a mesh run raised, or its process was lost; ``rank``
    names it (the lost process's first rank) and ``process`` its
    process."""

    def __init__(self, rank: int, exc: BaseException,
                 process: Optional[int] = None):
        where = "" if process is None else f" (process {process})"
        super().__init__(f"mesh rank {rank}{where} failed: {exc!r}")
        self.rank = rank
        self.process = process


class _Aborted(Exception):
    """Raised in a waiting rank when another rank ended the run."""


class Mesh:
    """Ranks on devices, with JAX's ``axis_names`` and ``shape``.

    ``devices`` is a sequence of ``torch.device`` (or strings), one per
    global rank; a device may repeat (several ranks on one card). The
    ranks are numbered in row-major order of ``shape``. A mesh over
    several processes (``init_multihost``) holds every rank's device
    label and runs only ``local_ranks``, this process's.
    """

    def __init__(self, devices: Sequence, axis_names: Sequence[str] = ("dp",),
                 shape: Optional[Sequence[int]] = None,
                 timeout: float = DEFAULT_TIMEOUT, *,
                 process_index: int = 0, process_count: int = 1,
                 backend: Optional[str] = None):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = tuple(axis_names)
        if shape is None:
            if len(self.axis_names) != 1:
                raise ValueError("pass shape= for multi-axis meshes")
            shape = (len(self.devices),)
        if len(shape) != len(self.axis_names):
            raise ValueError(
                f"shape {tuple(shape)} does not match axis_names "
                f"{self.axis_names}")
        if int(np.prod(shape)) != len(self.devices):
            raise ValueError(f"shape {tuple(shape)} does not hold "
                             f"{len(self.devices)} devices")
        if len(self.devices) % process_count:
            raise ValueError(f"{len(self.devices)} ranks do not split over "
                             f"{process_count} processes")
        self.shape = tuple(int(s) for s in shape)
        self.timeout = timeout
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.backend = backend
        per = len(self.devices) // self.process_count
        self.local_ranks = range(self.process_index * per,
                                 (self.process_index + 1) * per)
        self.reset_stats()

    def reset_stats(self) -> None:
        """Zero every rank's accumulated tallies (``stats``)."""
        self.stats = [collections.Counter() for _ in self.devices]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local_devices(self) -> list:
        """This process's ranks' devices, in rank order."""
        return [self.devices[r] for r in self.local_ranks]

    def is_local(self, rank: int) -> bool:
        return rank in self.local_ranks

    def rank_process(self, rank: int) -> int:
        """The process that runs global rank ``rank``."""
        return rank // len(self.local_ranks)

    def process_ranks(self, process: int) -> list:
        per = len(self.local_ranks)
        return list(range(process * per, (process + 1) * per))

    def __repr__(self) -> str:
        procs = ("" if self.process_count == 1 else
                 f", process {self.process_index} of {self.process_count}")
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"axis_names={self.axis_names}, shape={self.shape}{procs})")

    def run(self, fn: Callable) -> list:
        """``fn(comm)`` on one thread per rank of this process; returns
        the outputs in global rank order (None for the ranks of other
        processes). Raises ``RankFailed`` (chained to the original
        exception) for the first rank that failed, or for a lost
        process."""
        local = list(self.local_ranks)
        _load_cuda_linalg([self.devices[r] for r in local])
        link = _ProcessLink(self) if self.process_count > 1 else None
        group = _Group(self.size, local, self.timeout, link)
        outs = [None] * self.size
        comms = {r: Comm(group, r, self.devices[r]) for r in local}

        def body(rank):
            comm = comms[rank]
            try:
                with _device_scope(self.devices[rank]):
                    outs[rank] = fn(comm)
            except _Aborted:
                pass  # another rank's failure is the one reported
            except BaseException as exc:  # noqa: BLE001 re-raised below
                group.fail(rank, exc)
            finally:
                group.leave(rank)

        ctx0 = contextvars.copy_context()
        threads = [
            threading.Thread(
                target=(ctx0.run if i == 0 else (lambda f, *a: f(*a))),
                args=(body, r), name=f"mesh-rank-{r}", daemon=True)
            for i, r in enumerate(local)
        ]
        for t in threads:
            t.start()
        if link is not None:
            group.serve()
        for t in threads:
            # After a failure, a rank still busy outside the group (it
            # raises when it next enters a collective) gets ``timeout``
            # seconds more; the run does not wait on it past that.
            while t.is_alive():
                t.join(0.05)
                if group.failed_at is not None and (
                        time.monotonic() > group.failed_at + group.timeout):
                    break
        for r, comm in comms.items():
            self.stats[r].update(comm.tally)
        if group.failed is not None:
            rank, exc = group.failed
            if isinstance(exc, RankFailed):
                raise exc
            raise RankFailed(rank, exc) from exc
        return outs


@contextlib.contextmanager
def _device_scope(dev: torch.device):
    """The rank's card as the thread's current device (its current
    stream is then that card's), nothing for the CPU."""
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            yield
    else:
        yield


# The header of one rank in a cross-process exchange (int64 words).
_ST_COLLECTIVE, _ST_DONE, _ST_FAILED = 0, 1, 2
_MAX_DIMS = 6
_HEADER = 5 + _MAX_DIMS  # status, seq, op, ndim, dtype, shape[6]
_DTYPES = (torch.float32, torch.float64, torch.int32, torch.int64,
           torch.bool, torch.uint8, torch.float16, torch.bfloat16,
           torch.int16, torch.int8)
_OPS = ("all_gather", "psum", "pmin", "pmax")


class _ProcessLink:
    """The process-group side of a mesh run: the header and data
    all-gathers across processes, made by one thread."""

    def __init__(self, mesh: Mesh):
        import torch.distributed as dist

        self.dist = dist
        self.mesh = mesh
        self.nccl = mesh.backend == "nccl"
        self.stage = mesh.local_devices[0] if self.nccl else torch.device(
            "cpu")

    def all_gather(self, x: torch.Tensor) -> list:
        """Every process's ``x`` (one shape everywhere), in process
        order, on the staging device (host memory under gloo)."""
        x = x.to(self.stage).contiguous()
        parts = [torch.empty_like(x) for _ in range(self.mesh.process_count)]
        self.dist.all_gather(parts, x)
        return parts

    def lost(self, seq: int, exc: BaseException) -> RankFailed:
        """The failure of a process-group call, naming the lost peer."""
        me = self.mesh.process_index
        others = [p for p in range(self.mesh.process_count) if p != me]
        p = others[0]
        what = (f"mesh process {p} (ranks {self.mesh.process_ranks(p)}) was "
                "lost" if len(others) == 1
                else f"a mesh process among {others} was lost")
        return RankFailed(
            self.mesh.process_ranks(p)[0],
            RuntimeError(f"{what}: process {me}'s exchange #{seq} failed "
                         f"({type(exc).__name__}: {exc})"),
            process=p)


class _Group:
    """Shared state of one mesh run: a reusable barrier with failure and
    early-exit release, and two slot buffers used alternately (a rank
    writes buffer k % 2 only after every rank has read buffer k − 2's
    contents, so one barrier per collective suffices). With a process
    link, the barrier's release is the link thread's cross-process
    exchange (``serve``)."""

    def __init__(self, n: int, local: list, timeout: float,
                 link: Optional[_ProcessLink] = None):
        self.n = n
        self.local = local
        self.slot_of = {r: i for i, r in enumerate(local)}
        self.timeout = timeout
        self.link = link
        self.cond = threading.Condition()
        self.arrived = 0
        self.generation = 0
        self.failed = None  # (rank, exception) of the first failure
        self.failed_at = None  # time.monotonic() of that failure
        self.left: set = set()
        self.slots = [[None] * len(local), [None] * len(local)]
        self.published = [None, None]

    def fail(self, rank: int, exc: BaseException) -> None:
        with self.cond:
            self._fail(rank, exc)

    def _fail(self, rank: int, exc: BaseException) -> None:
        """Record the first failure and wake every waiting rank (the
        condition's lock is held)."""
        if self.failed is None:
            self.failed = (rank, exc)
            self.failed_at = time.monotonic()
        self.cond.notify_all()

    def leave(self, rank: int) -> None:
        with self.cond:
            self.left.add(rank)
            self.cond.notify_all()

    def exchange(self, rank: int, seq: int, item) -> list:
        """Deposit ``item`` as this rank's contribution to collective
        ``seq``, wait for every rank, return all contributions in global
        rank order."""
        buf = self.slots[seq % 2]
        with self.cond:
            if self.left:
                self._fail(rank, RuntimeError(
                    f"rank {rank} entered collective {seq} after ranks "
                    f"{sorted(self.left)} returned: a collective was not "
                    "entered by every rank"))
            if self.failed is not None:
                raise _Aborted()
            buf[self.slot_of[rank]] = item
            gen = self.generation
            self.arrived += 1
            if self.arrived == len(self.local) and self.link is None:
                self.published[seq % 2] = list(buf)
                self.arrived = 0
                self.generation += 1
                self.cond.notify_all()
            else:
                if self.arrived == len(self.local):
                    self.cond.notify_all()  # the link thread's turn
                done = self.cond.wait_for(
                    lambda: (self.generation != gen or self.failed is not None
                             or bool(self.left)),
                    self.timeout)
                if self.generation == gen:
                    if not done:
                        self._fail(rank, TimeoutError(
                            f"rank {rank} waited {self.timeout} s in "
                            f"collective {seq}; some rank never arrived"))
                    elif self.failed is None:
                        self._fail(rank, RuntimeError(
                            f"ranks {sorted(self.left)} left the group while "
                            f"rank {rank} waited in collective {seq}: a "
                            "collective was not entered by every rank"))
                    raise _Aborted()
            return list(self.published[seq % 2])

    def serve(self) -> None:
        """The link thread's loop: each time every local rank has
        deposited (or failed, or returned), exchange headers with the
        other processes, then the data; publish the global items. Ends
        when every rank of every process has returned, or at the first
        failure anywhere, which every process then reports."""
        link = self.link
        seq = 0
        while True:
            with self.cond:
                self.cond.wait_for(
                    lambda: (self.arrived == len(self.local)
                             or self.failed is not None
                             or len(self.left) == len(self.local)))
                if self.arrived == len(self.local) and any(
                        len(it[2]) > _MAX_DIMS for it in self.slots[seq % 2]):
                    self._fail(self.local[0], ValueError(
                        f"a collective of more than {_MAX_DIMS} dimensions "
                        "cannot cross processes"))
                if self.failed is not None:
                    status, items = _ST_FAILED, None
                elif self.arrived == len(self.local):
                    status, items = _ST_COLLECTIVE, list(self.slots[seq % 2])
                else:
                    status, items = _ST_DONE, None
                failed_rank = self.failed[0] if self.failed else -1
            hdr = torch.zeros((len(self.local), _HEADER), dtype=torch.int64)
            hdr[:, 0] = status
            hdr[:, 1] = seq
            if status == _ST_FAILED:
                hdr[:, 2] = failed_rank
            elif status == _ST_COLLECTIVE:
                for i, (s, op, shape, dtype, _) in enumerate(items):
                    hdr[i, 1] = s
                    hdr[i, 2] = _OPS.index(op)
                    hdr[i, 3] = len(shape)
                    hdr[i, 4] = _DTYPES.index(dtype)
                    if shape:
                        hdr[i, 5:5 + len(shape)] = torch.tensor(shape)
            try:
                heads = torch.cat(link.all_gather(hdr)).cpu()
            except Exception as exc:  # noqa: BLE001 any group failure
                self.fail(self.local[0], link.lost(seq, exc))
                return
            if status == _ST_FAILED:
                return  # every process now knows
            err = self._check_heads(heads)
            if err is not None:
                self.fail(*err)
                return
            if int(heads[0, 0]) == _ST_DONE:
                return
            dtype = items[0][3]
            wire = torch.stack([
                (t.view(torch.uint8) if t.dtype == torch.bool else t)
                .to(link.stage) for *_, t in items])
            try:
                parts = link.all_gather(wire)
            except Exception as exc:  # noqa: BLE001 any group failure
                self.fail(self.local[0], link.lost(seq, exc))
                return
            glob = []
            for p, part in enumerate(parts):
                for i in range(len(self.local)):
                    if p == link.mesh.process_index:
                        glob.append(items[i])
                    else:
                        t = part[i]
                        if dtype == torch.bool:
                            t = t.view(torch.bool)
                        glob.append((*items[0][:4], t))
            with self.cond:
                self.published[seq % 2] = glob
                self.arrived = 0
                self.generation += 1
                self.cond.notify_all()
            seq += 1

    def _check_heads(self, heads: torch.Tensor):
        """(rank, exception) for the first failure or mismatch that the
        gathered headers show, else None."""
        mesh = self.link.mesh
        failed = (heads[:, 0] == _ST_FAILED).nonzero()
        if len(failed):
            r = int(failed[0])
            rank = int(heads[r, 2])
            p = mesh.rank_process(r)
            return rank, RankFailed(rank, RuntimeError(
                f"rank {rank} failed in process {p}; that process reports "
                "the error"), process=p)

        def desc(r):
            h = heads[r].tolist()
            if h[0] == _ST_DONE:
                return f"rank {r} returned"
            shape = tuple(h[5:5 + h[3]])
            return (f"rank {r} {_OPS[h[2]]} #{h[1]} {shape} "
                    f"{_DTYPES[h[4]]}")

        for r in range(1, len(heads)):
            if not torch.equal(heads[r], heads[0]):
                me = self.local[0]
                return me, RuntimeError(
                    f"collective mismatch across processes: {desc(0)}, "
                    f"{desc(r)}: a collective was not entered by every rank "
                    "in the same order")
        return None


class Comm:
    """One rank's handle on the group: its rank, device and collectives."""

    def __init__(self, group: _Group, rank: int, device: torch.device):
        self._group = group
        self.rank = rank
        self.size = group.n
        self.device = device
        self.seq = 0
        self.tally: collections.Counter = collections.Counter()

    def axis_index(self) -> int:
        return self.rank

    def all_gather(self, x: torch.Tensor, _op: str = "all_gather") -> list:
        """Every rank's ``x`` (same shape and dtype on every rank), in
        rank order, on this rank's device."""
        seq = self.seq
        self.seq += 1
        self.tally["collectives"] += 1
        self.tally["bytes_sent"] += x.numel() * x.element_size()
        items = self._group.exchange(
            self.rank, seq, (seq, _op, tuple(x.shape), x.dtype, x))
        parts = []
        for r, (s, op, shape, dtype, t) in enumerate(items):
            if (s, op, shape, dtype) != (seq, _op, tuple(x.shape), x.dtype):
                raise RuntimeError(
                    f"collective mismatch: rank {self.rank} entered {_op} "
                    f"#{seq} {tuple(x.shape)} {x.dtype}, rank {r} {op} #{s} "
                    f"{shape} {dtype}")
            parts.append(t if t.device == self.device
                         else t.to(self.device))
        return parts

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over ranks, as a left fold in rank order (the same bits on
        every rank)."""
        parts = self.all_gather(x, "psum")
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        parts = self.all_gather(x, "pmin")
        acc = parts[0]
        for p in parts[1:]:
            acc = torch.minimum(acc, p)
        return acc

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        parts = self.all_gather(x, "pmax")
        acc = parts[0]
        for p in parts[1:]:
            acc = torch.maximum(acc, p)
        return acc


def _visible_cards(what: str) -> list:
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{what}: no CUDA card is visible; pass devices= "
            "(e.g. ['cpu'] * 4) to build a CPU mesh")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("dp",), devices=None,
              shape: Optional[Sequence[int]] = None, device=None,
              timeout: float = DEFAULT_TIMEOUT) -> Mesh:
    """A mesh over the first ``n_devices`` of ``devices``, in this process.

    ``devices`` default: one rank per visible card (``cuda:0`` ...); with
    ``device="cpu"`` (or no card and ``devices`` given) pass the ranks
    explicitly, e.g. ``devices=["cpu"] * 4`` for four CPU ranks, or
    ``["cuda:0"] * 4`` for four ranks on one card. ``device`` names one
    device for every rank of the default (``device="cpu"`` with
    ``n_devices`` ranks). 1-D by default (axis ``dp``); pass ``shape`` with
    several ``axis_names``, as for the JAX package's mesh.
    """
    if devices is None:
        if device is not None and torch.device(device).type != "cuda":
            devices = [torch.device(device)] * (n_devices or 1)
        else:
            devices = _visible_cards("make_mesh")
    devices = list(devices)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"make_mesh: {n_devices} ranks asked, "
                             f"{len(devices)} devices given")
        devices = devices[:n_devices]
    return Mesh(devices, axis_names, shape, timeout=timeout)


_ENV_KEYS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    heartbeat_timeout_seconds: Optional[float] = None,
    *,
    local_devices=None,
    backend: Optional[str] = None,
) -> Mesh:
    """Join the processes of a run into one ``torch.distributed`` group and
    return the global 2-D mesh, axes ``("host", "chip")``, of shape
    ``(num_processes, len(local_devices))``, ranks in row-major order
    (process 0's ranks first, as JAX orders ``jax.devices()``). Call it
    in every process, with the same ``coordinator_address``
    (``host:port``, where process 0 listens) and ``num_processes``, and
    its own ``process_id``.

    ``local_devices``: this process's ranks, one per visible card by
    default (raises without CUDA, as ``make_mesh`` does); the CPU tests
    pass ``["cpu"] * k``. Every process must give the same number.
    ``backend``: "nccl" by default for cards (one process per card),
    "gloo" for the CPU; pass "gloo" when several processes share one card
    (NCCL refuses two ranks of one communicator on one GPU; gloo stages
    the cards' tensors through host memory).

    ``heartbeat_timeout_seconds`` bounds every process-group call (100 s
    by default, JAX's): a peer that dies or stops answering fails the
    surviving processes' run with ``RankFailed`` naming it, and the
    caller exits instead of waiting (under gloo a killed peer's closed
    sockets fail the call at once; under NCCL the group's watchdog ends
    it at the bound). Recovery is a restart on a reformed mesh and a
    resume from the rolling segment checkpoint (runtime/checkpoint.py).

    With ``num_processes`` None or 1 this returns the 1-D ``dp`` mesh over
    ``local_devices``, as JAX does. Given a heartbeat and no process
    count, the cluster is read from the environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, the ``env://``
    counterpart of JAX's auto-detection); without those variables it
    raises: the caller asked for failure detection, so a silent single
    process would be worse.
    """
    import torch.distributed as dist

    if local_devices is None:
        local_devices = _visible_cards("init_multihost")
    local_devices = [torch.device(d) for d in local_devices]
    init_method = None
    if num_processes is None and heartbeat_timeout_seconds is not None:
        missing = [k for k in _ENV_KEYS if k not in os.environ]
        if missing:
            raise RuntimeError(
                "init_multihost: no process count given and the "
                f"environment describes no cluster (missing {missing})")
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
        init_method = "env://"
    if num_processes is None or num_processes == 1:
        return make_mesh(devices=local_devices)
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(f"init_multihost: process_id {process_id} is not "
                         f"in [0, {num_processes})")
    on_card = all(d.type == "cuda" for d in local_devices)
    if backend is None:
        backend = "nccl" if on_card else "gloo"
    if backend == "nccl":
        if not on_card:
            raise ValueError("init_multihost: nccl needs CUDA local_devices")
        torch.cuda.set_device(local_devices[0])
    if init_method is None:
        if not coordinator_address:
            raise ValueError("init_multihost: pass coordinator_address "
                             "(host:port of process 0)")
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend=backend, init_method=init_method, world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(
            seconds=heartbeat_timeout_seconds or DEFAULT_PROCESS_TIMEOUT))
    stage = local_devices[0] if backend == "nccl" else torch.device("cpu")
    k = torch.tensor([len(local_devices)], dtype=torch.int64, device=stage)
    counts = [torch.empty_like(k) for _ in range(num_processes)]
    dist.all_gather(counts, k)
    counts = [int(c) for c in counts]
    if len(set(counts)) != 1:
        raise ValueError(f"init_multihost: the processes hold different "
                         f"numbers of ranks {counts}")
    # Every rank's device label (type and index), for the mesh's record.
    mine = torch.tensor(
        [[d.type == "cuda", -1 if d.index is None else d.index]
         for d in local_devices], dtype=torch.int64, device=stage)
    labels = [torch.empty_like(mine) for _ in range(num_processes)]
    dist.all_gather(labels, mine)
    devices = []
    for lab in labels:
        for is_card, idx in lab.cpu().tolist():
            devices.append(torch.device("cuda", idx) if is_card
                           else torch.device("cpu"))
    return Mesh(devices, ("host", "chip"), (num_processes, counts[0]),
                process_index=process_id, process_count=num_processes,
                backend=backend)


def mesh_dp_axes(mesh: Mesh) -> tuple:
    """The axis-name tuple the ICP paths shard and reduce over: all mesh
    axes (a 1-D ``dp`` mesh and a 2-D host × chip mesh run the same
    code)."""
    return tuple(mesh.axis_names)


def _replicas(mesh: Mesh, make: Callable) -> list:
    """``make(device)`` once per distinct device of this process's ranks,
    indexed by global rank (None for other processes' ranks)."""
    copies: dict = {}
    return [copies.setdefault(d, make(d)) if mesh.is_local(r) else None
            for r, d in enumerate(mesh.devices)]


def to_global(x, mesh: Mesh, sharded: bool = True) -> list:
    """Place an array (numpy or a tensor) that every process holds in full
    on the mesh: for each of this process's ranks, that rank's tensor on
    its device (None for other processes' ranks).

    ``sharded=True`` (JAX's ``P(dp)``): the rank's contiguous row block of
    ``x`` padded by ``pad_to_multiple`` to a multiple of the rank count;
    ``sharded=False`` (``P()``): all of ``x``, one copy per distinct
    device.
    """
    if not sharded:
        return _replicas(mesh, lambda d: torch.as_tensor(x, device=d))
    if isinstance(x, torch.Tensor):
        if x.shape[0] % mesh.size:
            raise ValueError(f"to_global: {x.shape[0]} rows do not split "
                             f"over {mesh.size} ranks; pad them first")
    else:
        x, _ = pad_to_multiple(np.asarray(x), mesh.size)
    per = x.shape[0] // mesh.size
    return [torch.as_tensor(x[r * per:(r + 1) * per], device=d)
            if mesh.is_local(r) else None
            for r, d in enumerate(mesh.devices)]


def to_global_rows(shape, mesh: Mesh, fetch: Callable,
                   dtype=torch.float32) -> list:
    """The row-sharded form of ``to_global`` whose blocks are produced on
    demand: ``fetch(lo, hi)`` returns rows [lo, hi) of the logical array
    of ``shape`` (axis 0 a multiple of the rank count). It is called only
    for this process's ranks' row ranges, once per range, so no process
    materializes the whole array (the streamed ingest's contract for
    clouds beyond one host's memory). Returns, per global rank, the
    rank's block on its device (None for other processes' ranks)."""
    n = int(shape[0])
    if n % mesh.size:
        raise ValueError(f"to_global_rows: {n} rows do not split over "
                         f"{mesh.size} ranks")
    per = n // mesh.size
    cache: dict = {}
    out = [None] * mesh.size
    for r in mesh.local_ranks:
        key = (r * per, (r + 1) * per)
        if key not in cache:
            cache[key] = torch.as_tensor(np.asarray(fetch(*key)),
                                         dtype=dtype)
        out[r] = cache[key].to(mesh.devices[r])
    return out


def process_allgather(mesh: Mesh, rows: torch.Tensor) -> torch.Tensor:
    """Every process's ``rows`` (its ranks' rows, in rank order) joined
    in process order, which is global rank order, on the host. Call it in
    every process, outside ``Mesh.run``: the counterpart of
    ``multihost_utils.process_allgather`` for a registered cloud."""
    rows = rows.detach().cpu()
    if mesh.process_count == 1:
        return rows
    link = _ProcessLink(mesh)
    n = torch.tensor([rows.shape[0]], dtype=torch.int64)
    counts = [int(c) for c in link.all_gather(n)]
    pad = max(counts) - rows.shape[0]
    if pad:
        rows = torch.cat([rows, rows.new_zeros((pad,) + rows.shape[1:])])
    parts = link.all_gather(rows)
    return torch.cat([p[:c].cpu() for p, c in zip(parts, counts)])


def pad_to_multiple(x: np.ndarray, m: int):
    """Pad axis 0 of ``x`` to a multiple of ``m`` (zeros); returns
    (padded, weight) where weight is 1.0 for real rows, 0.0 for padding."""
    n = len(x)
    n_pad = -(-n // m) * m
    w = np.zeros(n_pad, x.dtype)
    w[:n] = 1.0
    if n_pad == n:
        return x, w
    out = np.zeros((n_pad,) + x.shape[1:], x.dtype)
    out[:n] = x
    return out, w
