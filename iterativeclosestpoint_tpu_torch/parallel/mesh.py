"""The single-host mesh: one thread per rank and a small collective group.

Counterpart of the JAX package's ``parallel/mesh.py`` for one controller
driving every local device (``make_mesh`` :28, ``mesh_dp_axes`` :113,
``pad_to_multiple`` :167). JAX runs one program on every device of a
``jax.sharding.Mesh`` (``shard_map``) with ``psum``/``pmin``/``all_gather``
between them. PyTorch's own single-process idiom for that is one thread
per device (``torch.nn.parallel.parallel_apply``): ``Mesh.run(fn)`` calls
``fn(comm)`` on one thread per rank, inside ``torch.cuda.device`` of the
rank's card, and returns every rank's output. Torch operations and the
kernels' ctypes calls release the interpreter lock, so the ranks' host
work overlaps.

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
  plane mode), ``collectives``, and whatever a path adds (the partitioned
  target's repair passes and queries). ``Mesh.stats`` sums each rank's
  tallies over runs until ``Mesh.reset_stats()``.

Rank 0 runs in a copy of the caller's ``contextvars`` context, so a
``runtime.timing.collect`` block around a mesh call records rank 0's
stages; the other ranks run in fresh contexts and record none (a
collector is not shared between threads).

Left out here, for the multi-process mode (ROADMAP P15b):
``init_multihost`` (:58), ``to_global`` and ``to_global_rows`` (:119-165).
A ``torch.distributed`` group (NCCL across cards, gloo for CPU tests) can
then stand behind the same ``Comm`` methods.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

DEFAULT_TIMEOUT = 600.0  # seconds a rank waits for the others

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
    """A rank of a mesh run raised; ``rank`` names it."""

    def __init__(self, rank: int, exc: BaseException):
        super().__init__(f"mesh rank {rank} failed: {exc!r}")
        self.rank = rank


class _Aborted(Exception):
    """Raised in a waiting rank when another rank ended the run."""


class Mesh:
    """Ranks on devices, with JAX's ``axis_names`` and ``shape``.

    ``devices`` is a sequence of ``torch.device`` (or strings); a device
    may repeat (several ranks on one card). The ranks are numbered in
    row-major order of ``shape``.
    """

    def __init__(self, devices: Sequence, axis_names: Sequence[str] = ("dp",),
                 shape: Optional[Sequence[int]] = None,
                 timeout: float = DEFAULT_TIMEOUT):
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
        self.shape = tuple(int(s) for s in shape)
        self.timeout = timeout
        self.reset_stats()

    def reset_stats(self) -> None:
        """Zero every rank's accumulated tallies (``stats``)."""
        self.stats = [collections.Counter() for _ in self.devices]

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"axis_names={self.axis_names}, shape={self.shape})")

    def run(self, fn: Callable) -> list:
        """``fn(comm)`` on one thread per rank; returns the outputs in
        rank order. Raises ``RankFailed`` (chained to the original
        exception) for the first rank that failed."""
        _load_cuda_linalg(self.devices)
        group = _Group(self.size, self.timeout)
        outs = [None] * self.size
        comms = [Comm(group, r, d) for r, d in enumerate(self.devices)]

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
                target=(ctx0.run if r == 0 else (lambda f, *a: f(*a))),
                args=(body, r), name=f"mesh-rank-{r}", daemon=True)
            for r in range(self.size)
        ]
        for t in threads:
            t.start()
        for t in threads:
            # After a failure, a rank still busy outside the group (it
            # raises when it next enters a collective) gets ``timeout``
            # seconds more; the run does not wait on it past that.
            while t.is_alive():
                t.join(0.05)
                if group.failed_at is not None and (
                        time.monotonic() > group.failed_at + group.timeout):
                    break
        for acc, comm in zip(self.stats, comms):
            acc.update(comm.tally)
        if group.failed is not None:
            rank, exc = group.failed
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


class _Group:
    """Shared state of one mesh run: a reusable barrier with failure and
    early-exit release, and two slot buffers used alternately (a rank
    writes buffer k % 2 only after every rank has read buffer k − 2's
    contents, so one barrier per collective suffices)."""

    def __init__(self, n: int, timeout: float):
        self.n = n
        self.timeout = timeout
        self.cond = threading.Condition()
        self.arrived = 0
        self.generation = 0
        self.failed = None  # (rank, exception) of the first failure
        self.failed_at = None  # time.monotonic() of that failure
        self.left: set = set()
        self.slots = [[None] * n, [None] * n]

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
        ``seq``, wait for every rank, return all contributions."""
        buf = self.slots[seq % 2]
        with self.cond:
            if self.left:
                self._fail(rank, RuntimeError(
                    f"rank {rank} entered collective {seq} after ranks "
                    f"{sorted(self.left)} returned: a collective was not "
                    "entered by every rank"))
            if self.failed is not None:
                raise _Aborted()
            buf[rank] = item
            gen = self.generation
            self.arrived += 1
            if self.arrived == self.n:
                self.arrived = 0
                self.generation += 1
                self.cond.notify_all()
            else:
                done = self.cond.wait_for(
                    lambda: (self.generation != gen or self.failed is not None
                             or bool(self.left)),
                    self.timeout)
                if self.generation == gen:
                    if not done:
                        self._fail(rank, TimeoutError(
                            f"rank {rank} waited {self.timeout} s in "
                            f"collective {seq}; some rank never arrived"))
                    else:
                        self._fail(rank, RuntimeError(
                            f"ranks {sorted(self.left)} left the group while "
                            f"rank {rank} waited in collective {seq}: a "
                            "collective was not entered by every rank"))
                    raise _Aborted()
            return list(buf)


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


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("dp",), devices=None,
              shape: Optional[Sequence[int]] = None, device=None,
              timeout: float = DEFAULT_TIMEOUT) -> Mesh:
    """A mesh over the first ``n_devices`` of ``devices``.

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
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "make_mesh: no CUDA card is visible; pass devices= "
                    "(e.g. ['cpu'] * 4) to build a CPU mesh")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"make_mesh: {n_devices} ranks asked, "
                             f"{len(devices)} devices given")
        devices = devices[:n_devices]
    return Mesh(devices, axis_names, shape, timeout=timeout)


def mesh_dp_axes(mesh: Mesh) -> tuple:
    """The axis-name tuple the ICP paths shard and reduce over: all mesh
    axes (a 1-D ``dp`` mesh and a 2-D host × chip mesh run the same
    code)."""
    return tuple(mesh.axis_names)


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
