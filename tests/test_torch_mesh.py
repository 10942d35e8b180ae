"""The single-host mesh (``parallel/mesh.py``) and the kernel layer's
thread safety, on CPU ranks.

Collectives are held against numpy exactly (a gather moves bits, a min
or max is exact, and ``psum`` is defined as the left fold in rank order,
so it is checked bit for bit against that fold). Failure handling is
held to time: a failing rank ends the run within a few seconds, not at
the barrier's timeout. ``pad_to_multiple`` is held equal to the JAX
package's. About 5 s alone on one worker.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from iterativeclosestpoint_tpu.parallel.mesh import (
    pad_to_multiple as jax_pad_to_multiple,
)
from iterativeclosestpoint_tpu_torch.ops import _build
from iterativeclosestpoint_tpu_torch.ops import sweep_kernels as sk
from iterativeclosestpoint_tpu_torch.parallel.mesh import (
    Mesh,
    RankFailed,
    make_mesh,
    mesh_dp_axes,
    pad_to_multiple,
)

DTYPES = [torch.float32, torch.float64, torch.int32]


def _values(rank, dtype, n=7):
    rng = np.random.default_rng(100 + rank)
    x = rng.normal(size=n) * 10.0 ** rng.integers(-3, 4, size=n)
    return torch.as_tensor(x).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_collectives_match_numpy(dtype):
    mesh = make_mesh(devices=["cpu"] * 4)

    def fn(comm):
        x = _values(comm.rank, dtype)
        return (torch.stack(comm.all_gather(x)), comm.psum(x),
                comm.pmin(x), comm.pmax(x), comm.axis_index())

    outs = mesh.run(fn)
    parts = np.stack([_values(r, dtype).numpy() for r in range(4)])
    fold = parts[0].copy()
    for p in parts[1:]:
        fold = fold + p
    for r, (gat, ps, mn, mx, idx) in enumerate(outs):
        assert idx == r
        np.testing.assert_array_equal(gat.numpy(), parts)
        np.testing.assert_array_equal(ps.numpy(), fold)
        np.testing.assert_array_equal(mn.numpy(), parts.min(axis=0))
        np.testing.assert_array_equal(mx.numpy(), parts.max(axis=0))


def test_psum_is_the_rank_order_fold_on_every_rank():
    """f32 addition is not associative; every rank's psum must be the
    left fold ((x0 + x1) + x2) + x3 bit for bit, whatever the threads'
    timing (a stress run with a short switch interval)."""
    mesh = make_mesh(devices=["cpu"] * 4)
    vals = [torch.tensor([1e8, 1.0, -1e8, 3.3], dtype=torch.float32) * (r + 1)
            + torch.tensor([0.1, 1e-3, 7.0, -2.0]) * r for r in range(4)]
    fold = ((vals[0] + vals[1]) + vals[2]) + vals[3]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(20):
            outs = mesh.run(lambda c: [c.psum(vals[c.rank])
                                       for _ in range(10)])
            for per_rank in outs:
                for got in per_rank:
                    assert torch.equal(got, fold)
    finally:
        sys.setswitchinterval(old)


@pytest.mark.parametrize("mode", ["raise", "leave", "timeout"])
def test_failing_rank_ends_the_run(mode):
    """A rank that raises, or returns while the others wait in a
    collective, fails the run at once, naming the rank; a rank that never
    arrives breaks the wait after the timeout."""
    timeout = 0.5 if mode == "timeout" else 60.0
    mesh = make_mesh(devices=["cpu"] * 4, timeout=timeout)
    hold = threading.Event()

    def fn(comm):
        comm.psum(torch.ones(2))
        if comm.rank == 2:
            if mode == "raise":
                raise ValueError("rank two broke")
            if mode == "leave":
                return None
            hold.wait(10.0)
        return comm.psum(torch.ones(2))

    t0 = time.perf_counter()
    with pytest.raises(RankFailed) as info:
        mesh.run(fn)
    hold.set()
    assert time.perf_counter() - t0 < 8.0
    if mode == "raise":
        assert info.value.rank == 2
        assert isinstance(info.value.__cause__, ValueError)
    elif mode == "leave":
        assert "not entered by every rank" in str(info.value)
    else:
        assert isinstance(info.value.__cause__, TimeoutError)


def test_collective_mismatch_raises():
    mesh = make_mesh(devices=["cpu"] * 2)
    with pytest.raises(RankFailed, match="collective mismatch"):
        mesh.run(lambda c: c.psum(torch.zeros(3 + c.rank)))


@pytest.mark.parametrize("n,m", [(5, 4), (8, 4), (1, 8), (13, 3)])
def test_pad_to_multiple_matches_jax(n, m):
    x = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    got, w = pad_to_multiple(x, m)
    ref, w_ref = jax_pad_to_multiple(x, m)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(w, w_ref)
    assert got.dtype == ref.dtype and w.dtype == w_ref.dtype


def test_byte_counter():
    """Each rank's tally counts the bytes it contributed to collectives,
    accumulated over runs until reset."""
    mesh = make_mesh(devices=["cpu"] * 3)

    def fn(comm):
        comm.psum(torch.zeros(5, dtype=torch.float32))      # 20 B
        comm.pmax(torch.zeros((), dtype=torch.int32))       # 4 B
        comm.all_gather(torch.zeros(3, dtype=torch.float64))  # 24 B

    mesh.run(fn)
    mesh.run(fn)
    for st in mesh.stats:
        assert st["bytes_sent"] == 2 * 48 and st["collectives"] == 6
    mesh.reset_stats()
    assert all(not st for st in mesh.stats)


def test_make_mesh_shapes_and_errors():
    mesh = make_mesh(devices=["cpu"] * 4, axis_names=("host", "chip"),
                     shape=(2, 2))
    assert mesh.size == 4 and mesh.shape == (2, 2)
    assert mesh_dp_axes(mesh) == ("host", "chip")
    assert make_mesh(n_devices=2, devices=["cpu"] * 4).size == 2
    assert make_mesh(device="cpu", n_devices=3).devices == [
        torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="shape"):
        Mesh(["cpu"] * 4, axis_names=("a", "b"))
    with pytest.raises(ValueError, match="does not hold"):
        Mesh(["cpu"] * 3, axis_names=("a", "b"), shape=(2, 2))
    with pytest.raises(ValueError, match="ranks asked"):
        make_mesh(n_devices=5, devices=["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make_mesh()


def test_kernel_build_is_thread_safe(tmp_path, monkeypatch):
    """Four threads reach the build at once: each source compiles once
    (one compiler process each, writing a file named after its process
    and thread) and no temporary file is left. The compiler is a stand-in
    script, so the test runs without the CUDA toolkit."""
    log = tmp_path / "calls.log"
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!" + sys.executable + "\n"
        "import sys, time\n"
        f"open({str(log)!r}, 'a').write(sys.argv[-1] + '\\n')\n"
        "time.sleep(0.3)\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'wb').write(b'lib')\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    errors = []

    def worker():
        try:
            _build.build_all()
        except Exception as e:  # noqa: BLE001 collected for the assert
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads) and not errors
    calls = log.read_text().split()
    assert sorted(calls) == sorted(str(_build.CSRC / f"{n}.cu")
                                   for n in _build.SOURCES)
    built = sorted(p.name for p in (tmp_path / "build").iterdir())
    assert not [n for n in built if n.endswith(".tmp")]
    assert len([n for n in built if n.endswith(".so")]) == len(_build.SOURCES)


def test_launch_tallies_are_thread_safe():
    """Concurrent launches from mesh ranks lose no count (a stress run
    with more threads than cores and a short switch interval)."""
    sk.reset_launches()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker():
            for _ in range(2000):
                sk._tally("brute_nn", (128, 256))

        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert sk.LAUNCHES["brute_nn"] == 32000
    assert sk.LAUNCH_SHAPES[("brute_nn", (128, 256))] == 32000
    sk.reset_launches()


def test_launch_uses_the_tensors_card(monkeypatch):
    """``_launch`` takes the stream of the device it is given (a rank's
    card), not the process's current device. Stand-ins for the CUDA calls
    record what they are asked for, so the test runs without a card."""
    seen = []

    class Stream:
        cuda_stream = 1234

    class Ctx:
        def __init__(self, dev):
            seen.append(("device", dev))

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    class Lib:
        @staticmethod
        def brute_nn(*args):
            seen.append(("stream", args[-1].value))
            return 0

    def current_stream(dev=None):
        seen.append(("current_stream", dev))
        return Stream()

    monkeypatch.setattr(torch.cuda, "device", Ctx)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(_build, "library", lambda name: Lib)
    dev1 = torch.device("cuda", 1)
    sk._launch("brute_nn", (1, 1), dev1, 0, 1, 0, 1, 1, 1, 0)
    assert seen == [("device", dev1), ("current_stream", dev1),
                    ("stream", 1234)]
    sk.reset_launches()
