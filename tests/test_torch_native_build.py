"""The port's native library builds once when processes start together.

Six processes, each pointing ``runtime/native.py`` at a private copy of
``native/`` (the same ``icp_native.cpp`` and ``Makefile``), are released
at the same moment and call ``native_available()``. Each must load the
library, only one may run ``make`` (the others wait on the build lock and
find the finished file), and ``octree_nn_baseline`` must give one answer
in all of them. Skipped only where no compiler can build the library at
all. About 10 s alone on one worker (six interpreter starts importing
torch, one build).
"""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from iterativeclosestpoint_tpu_torch.runtime import native as tnative

REPO = Path(__file__).resolve().parents[1]
NPROC = 6

# A child: point the loader at the copy, wait for the start signal, load,
# count its own make runs, and report one JSON line.
CHILD = r"""
import json, subprocess, sys, time
from pathlib import Path
sys.path.insert(0, sys.argv[1])
import numpy as np
from iterativeclosestpoint_tpu_torch.runtime import native
work, rank = Path(sys.argv[2]), sys.argv[3]
native._NATIVE_DIR = work / "native"
native._LIB_PATH = native._NATIVE_DIR / "libicpnative_torch.so"
native._LOCK_PATH = native._NATIVE_DIR / ".libicpnative_torch.lock"
makes = []
run = subprocess.run
def counted(cmd, *a, **k):
    if cmd and cmd[0] == "make":
        makes.append(cmd)
    return run(cmd, *a, **k)
native.subprocess.run = counted
(work / f"ready.{rank}").touch()
while not (work / "go").exists():
    time.sleep(0.005)
ok = native.native_available()
rng = np.random.default_rng(40)
tgt, q = rng.uniform(-50, 50, (4000, 3)), rng.uniform(-50, 50, (1000, 3))
nn = native.octree_nn_baseline(tgt, q).tolist() if ok else None
print(json.dumps({"ok": ok, "makes": len(makes), "nn": nn,
                  "failure": native.native_failure()}))
"""


def _no_compiler() -> bool:
    """True where the repo's own library cannot be built for want of a
    compiler or of make (the only reason this test skips)."""
    if tnative.native_available():
        return False
    why = tnative.native_failure()
    return ("could not run" in why or "not found" in why
            or "No such file" in why)


def test_simultaneous_loads_build_once(tmp_path):
    if _no_compiler():
        pytest.skip("no compiler for native/: " + tnative.native_failure())
    (tmp_path / "native").mkdir()
    for name in ("icp_native.cpp", "Makefile"):
        shutil.copy(REPO / "native" / name, tmp_path / "native" / name)
    logs = [open(tmp_path / f"out.{r}", "w+") for r in range(NPROC)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(REPO), str(tmp_path), str(r)],
        stdout=f, stderr=subprocess.STDOUT, cwd=tmp_path,
        env={k: v for k, v in os.environ.items() if k != "XLA_FLAGS"})
        for r, f in enumerate(logs)]
    try:
        deadline = time.monotonic() + 120
        while not all((tmp_path / f"ready.{r}").exists()
                      for r in range(NPROC)):
            assert all(p.poll() is None for p in procs), "a child died"
            assert time.monotonic() < deadline, "children never got ready"
            time.sleep(0.01)
        (tmp_path / "go").touch()
        for p in procs:
            p.wait(timeout=120)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for p, f in zip(procs, logs):
        f.seek(0)
        text = f.read()
        f.close()
        assert p.returncode == 0, text
        outs.append(json.loads(text.strip().splitlines()[-1]))
    assert all(o["ok"] for o in outs), [o["failure"] for o in outs]
    assert sum(o["makes"] for o in outs) == 1
    assert all(o["nn"] == outs[0]["nn"] for o in outs)
    native = tmp_path / "native"
    assert (native / "libicpnative_torch.so").exists()
    assert not list(native.glob("*.tmp.so"))  # the temporary name is gone
    assert not (native / "libicpnative.so").exists()  # never the JAX file
