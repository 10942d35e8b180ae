"""Port parity: the registration session, the ``icp-torch`` CLI and
profiling on the CPU, against the JAX package's session on the same LAS
files. Mirrors ``test_runtime.py``'s single-device tests.

Tolerances: the two packages' sessions run f32 and sum in different
orders, so they must agree on iterations and stop message and within
1e-4 m of registration error (the f32 parity gate of PARITY.md). Within
the port, a checkpoint resume and a live (segmented) run are held bit for
bit against the uninterrupted run: the carry is the whole loop state.
"""

import json

import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from iterativeclosestpoint_tpu.io.las import write_las as jax_write_las
from iterativeclosestpoint_tpu.runtime.session import (
    RegistrationSession as JaxSession,
)
from iterativeclosestpoint_tpu.utils.config import ICPConfig as JaxConfig
from iterativeclosestpoint_tpu.utils.synth import make_registration_pair
from iterativeclosestpoint_tpu_torch.cli import main as cli_main
from iterativeclosestpoint_tpu_torch.io.las import read_las
from iterativeclosestpoint_tpu_torch.runtime.checkpoint import load_checkpoint
from iterativeclosestpoint_tpu_torch.runtime.metrics import read_history_json
from iterativeclosestpoint_tpu_torch.runtime.session import RegistrationSession
from iterativeclosestpoint_tpu_torch.utils.config import (
    AppSettings,
    ICPConfig,
)


def _reg_err(Ta, Tb, pts):
    pa = pts @ Ta[:3, :3].T + Ta[:3, 3]
    pb = pts @ Tb[:3, :3].T + Tb[:3, 3]
    return float(np.linalg.norm(pa - pb, axis=1).max())


def _pair_files(tmp_path, n=1500, seed=100):
    src, tgt, T = make_registration_pair(n=n, seed=seed, noise_sigma=0.01)
    sp, tp = tmp_path / "src.las", tmp_path / "tgt.las"
    jax_write_las(sp, src)
    jax_write_las(tp, tgt)
    return sp, tp


def _sessions(sp, tp):
    a = RegistrationSession(device="cpu")
    b = JaxSession()
    for s in (a, b):
        s.load_source(sp)
        s.load_target(tp)
    return a, b


@pytest.mark.parametrize("backend", ["bruteforce", "pallas"])
def test_session_matches_jax(tmp_path, backend):
    sp, tp = _pair_files(tmp_path)
    a, b = _sessions(sp, tp)
    ra = a.run(config=ICPConfig(max_iterations=10, nn_backend=backend))
    rb = b.run(config=JaxConfig(max_iterations=10, nn_backend=backend))
    assert (ra.iterations, ra.message) == (rb.iterations, rb.message)
    assert _reg_err(ra.transform, rb.transform, a.original_source) <= 1e-4
    np.testing.assert_allclose(a.source, b.source, atol=1e-4)
    np.testing.assert_array_equal(a.replay(0), a.original_source)
    T = ra.history_transform[2]
    np.testing.assert_allclose(
        a.replay(3), a.original_source @ T[:3, :3].T + T[:3, 3], atol=1e-9)
    assert len(a.history) == 1 and a.history[0].iterations == ra.iterations


def test_multiscale_pallas_session_matches_jax(tmp_path):
    """A 12k multiscale pallas session, with the session's default
    cell_capacity (10) passed to the engine as the JAX session does."""
    sp, tp = _pair_files(tmp_path, n=12_000, seed=95)
    a, b = _sessions(sp, tp)
    ra = a.run(config=ICPConfig(max_iterations=30, nn_backend="pallas"),
               multiscale=True, coarse_max_points=2000)
    rb = b.run(config=JaxConfig(max_iterations=30, nn_backend="pallas"),
               multiscale=True, coarse_max_points=2000)
    assert (ra.iterations, ra.message) == (rb.iterations, rb.message)
    assert ra.nn_resolution == rb.nn_resolution
    assert _reg_err(ra.transform, rb.transform, a.original_source) <= 1e-4


def test_session_artifacts(tmp_path):
    sp, tp = _pair_files(tmp_path)
    sess, _ = _sessions(sp, tp)
    res = sess.run(config=ICPConfig(max_iterations=15,
                                    nn_backend="bruteforce"),
                   checkpoint_path=tmp_path / "ckpt.json")
    out = tmp_path / "registered.las"
    sess.save_result(out)
    back, hdr = read_las(out)
    assert hdr.scale == sess.source_header.scale  # georeference kept
    np.testing.assert_allclose(back, sess.source, atol=0.001)
    sess.save_report(txt_path=tmp_path / "t.txt",
                     json_path=tmp_path / "t.json")
    assert "P_target = R * P_source + t" in (tmp_path / "t.txt").read_text()
    hist = read_history_json(tmp_path / "t.json")
    assert hist["iterations"] == res.iterations
    np.testing.assert_array_equal(hist["transform"], res.transform)
    ckpt = load_checkpoint(tmp_path / "ckpt.json")
    np.testing.assert_array_equal(ckpt["transform"], res.transform)
    sess.export_html(tmp_path / "v.html")
    assert "<canvas" in (tmp_path / "v.html").read_text()


def _cli(*argv):
    return cli_main(["--device", "cpu", *map(str, argv)])


def _iteration_rows(path):
    return [{k: v for k, v in json.loads(line).items() if k != "ts"}
            for line in path.read_text().splitlines()
            if json.loads(line)["kind"] == "iteration"]


def test_cli_resume_and_live_bit_identical(tmp_path):
    """10 iterations in one run; 5, then 5 more resumed from the
    checkpoint; and 10 in live segments of 5: the same transforms, rmse
    trail and per-iteration records, bit for bit."""
    sp, tp = tmp_path / "s.las", tmp_path / "t.las"
    assert _cli("synth", sp, tp, "--n", "2500", "--seed", "11",
                "--noise", "0.02") == 0
    run = ("run", sp, tp, "--nn-backend", "pallas", "--tolerance", "1e-10")
    assert _cli(*run, "--max-iterations", "10", "--checkpoint",
                tmp_path / "a.json", "--metrics", tmp_path / "a.jsonl") == 0
    assert _cli(*run, "--max-iterations", "5", "--checkpoint",
                tmp_path / "b.json") == 0
    assert _cli(*run, "--resume", tmp_path / "b.json", "--max-iterations",
                "10", "--checkpoint", tmp_path / "c.json") == 0
    a, b, c = (load_checkpoint(tmp_path / f"{x}.json") for x in "abc")
    assert (a["iteration"], b["iteration"], c["iteration"]) == (10, 5, 10)
    np.testing.assert_array_equal(c["transform"], a["transform"])
    np.testing.assert_array_equal(c["transform_local"], a["transform_local"])
    assert b["rmse_history"] + c["rmse_history"] == a["rmse_history"]
    assert (c["prev_error"], c["no_improve"]) == (a["prev_error"],
                                                  a["no_improve"])

    assert _cli(*run, "--max-iterations", "10", "--live-every", "5",
                "--metrics", tmp_path / "l.jsonl", "--checkpoint",
                tmp_path / "l.json", "--html", tmp_path / "l.html") == 0
    live, once = (_iteration_rows(tmp_path / f"{x}.jsonl") for x in "la")
    assert len(live) == 10 and live == once
    lck = load_checkpoint(tmp_path / "l.json")
    np.testing.assert_array_equal(lck["transform"], a["transform"])
    assert "http-equiv" not in (tmp_path / "l.html").read_text()


def test_live_session_checkpoints_and_stop(tmp_path):
    """Segment-boundary checkpoints carry the exact state: resuming the
    first boundary's checkpoint lands on the uninterrupted run. A stop
    request ends the run at a boundary with 'stopped by user'."""
    sp, tp = _pair_files(tmp_path, seed=101)
    cfg = ICPConfig(max_iterations=9, nn_backend="bruteforce",
                    tolerance=1e-10)
    full, _ = _sessions(sp, tp)
    ref = full.run(config=cfg)

    saved = []
    sess, _ = _sessions(sp, tp)
    orig = sess.metrics.iteration

    def spy(rec, total):
        orig(rec, total)
        if rec["iteration"] == 3:
            saved.append((tmp_path / "k.json").read_text()
                         if (tmp_path / "k.json").exists() else None)

    sess.metrics.iteration = spy
    sess.run(config=cfg, live_every=3, checkpoint_path=tmp_path / "k.json")
    assert saved == [None]  # the first boundary's file comes after rec 3
    first, _ = _sessions(sp, tp)
    first.run(config=ICPConfig(max_iterations=3, nn_backend="bruteforce",
                               tolerance=1e-10), live_every=3,
              checkpoint_path=tmp_path / "k3.json")
    from iterativeclosestpoint_tpu_torch.runtime.checkpoint import (
        resume_arguments,
    )

    patch = resume_arguments(load_checkpoint(tmp_path / "k3.json"), 9)
    rest, _ = _sessions(sp, tp)
    res = rest.run(config=ICPConfig(max_iterations=patch["max_iterations"],
                                    nn_backend="bruteforce",
                                    tolerance=1e-10),
                   resume_carry=patch["resume_carry"], iteration_base=3)
    np.testing.assert_array_equal(res.transform, ref.transform)
    np.testing.assert_array_equal(res.history_rmse, ref.history_rmse[3:])

    stopper, _ = _sessions(sp, tp)
    stopper.request_stop()
    stopper.metrics.iteration = lambda rec, total: stopper.request_stop()
    res = stopper.run(config=cfg, live_every=3)
    assert res.message == "stopped by user" and res.iterations == 3


def test_run_async_and_errors(tmp_path):
    sp, tp = _pair_files(tmp_path)
    sess, _ = _sessions(sp, tp)
    th = sess.run_async(config=ICPConfig(max_iterations=5,
                                         nn_backend="bruteforce"))
    th.join(120)
    assert not sess.is_running() and sess.error is None
    assert sess.result.iterations >= 1
    # The multi-device modes run, on a 1-rank CPU mesh here: "dp" gives
    # the single-device result bit for bit, "partition" (x-sorted source,
    # other summation order) within 1e-4 m.
    cfg = ICPConfig(max_iterations=5, nn_backend="bruteforce")
    runs = {}
    for mode in ("none", "dp", "partition"):
        sess.load_source(sp)
        runs[mode] = sess.run(config=cfg, parallel=mode)
    src = read_las(sp)[0]
    np.testing.assert_array_equal(runs["dp"].transform,
                                  runs["none"].transform)
    assert runs["partition"].iterations == runs["none"].iterations
    assert _reg_err(runs["partition"].transform, runs["none"].transform,
                    src) < 1e-4
    with pytest.raises(ValueError, match="parallel"):
        sess.run(parallel="mesh")
    with pytest.raises(RuntimeError, match="load source"):
        RegistrationSession(device="cpu").run()


def test_grid_resolution_and_cell_capacity_reach_engine(tmp_path,
                                                         monkeypatch):
    """A forced grid_resolution builds that grid (nn_resolution and the
    log line); cell_capacity reaches the engine, which uses it only for
    hashgrid (it sizes that grid's cells) and ignores it elsewhere, bit
    for bit."""
    sp, tp = _pair_files(tmp_path)
    sess, _ = _sessions(sp, tp)
    lines = []
    sess.metrics.log = lambda msg: lines.append(str(msg))
    res = sess.run(config=ICPConfig(max_iterations=3, nn_backend="pallas",
                                    grid_resolution=16))
    assert res.nn_resolution == 16
    assert any("nn grid resolution: 16" in ln for ln in lines)
    runs = []
    for cap in (5, 100):
        s, _ = _sessions(sp, tp)
        runs.append(s.run(config=ICPConfig(max_iterations=4,
                                           nn_backend="pallas",
                                           cell_capacity=cap)))
    assert runs[0].nn_resolution != 16
    np.testing.assert_array_equal(runs[0].transform, runs[1].transform)
    np.testing.assert_array_equal(runs[0].history_rmse,
                                  runs[1].history_rmse)
    from iterativeclosestpoint_tpu_torch.ops import hashgrid

    built = []
    real_build = hashgrid.build_hashgrid

    def spy(*a, **k):
        grid, cap = real_build(*a, **k)
        built.append((cap, grid.overflow_pts.shape[0]))
        return grid, cap

    monkeypatch.setattr(hashgrid, "build_hashgrid", spy)
    hg = [_sessions(sp, tp)[0].run(config=ICPConfig(
              max_iterations=3, nn_backend="hashgrid", grid_resolution=8,
              cell_capacity=cap)) for cap in (5, 100)]
    assert [b[0] for b in built] == [5, 100]
    assert built[0][1] > built[1][1]  # a smaller capacity overflows more
    assert hg[0].nn_resolution == hg[1].nn_resolution == 8
    # The grid changes, the exact NN and so the trajectory do not.
    np.testing.assert_array_equal(hg[0].transform, hg[1].transform)


def test_cli_end_to_end(tmp_path, capsys, monkeypatch):
    sp, tp = tmp_path / "s.las", tmp_path / "t.las"
    assert _cli("synth", sp, tp, "--n", "1500", "--seed", "3", "--noise",
                "0.01", "--transform-out", tmp_path / "truth.json") == 0
    assert _cli("info", sp, "--full") == 0
    out = capsys.readouterr().out
    assert "points:         1500" in out and "bounds X:" in out
    reg, hist = tmp_path / "reg.las", tmp_path / "hist.jsonl"
    assert _cli("run", sp, tp, "-o", reg, "--max-iterations", "10",
                "--nn-backend", "bruteforce", "--history", hist,
                "--checkpoint", tmp_path / "ck.json",
                "--html", tmp_path / "v.html") == 0
    report = tmp_path / "reg_transform.json"
    assert reg.exists() and report.exists() and (tmp_path / "v.html").exists()
    rp = tmp_path / "replay.las"
    assert _cli("replay", sp, report, "-k", "3", "-o", rp) == 0
    src, _ = read_las(sp)
    T = read_history_json(report)["history"][2]["transform"]
    np.testing.assert_allclose(read_las(rp)[0], src @ T[:3, :3].T + T[:3, 3],
                               atol=0.0005 + 1e-9)
    assert _cli("status", "--history", hist) == 0
    assert "runs: 1" in capsys.readouterr().out
    spath = tmp_path / "settings.json"
    assert _cli("settings", "--settings", spath,
                "--set", "icp.max_iterations=77") == 0
    assert AppSettings.load(spath).icp.max_iterations == 77
    assert _cli("view", sp, tp, "-o", tmp_path / "v2.html",
                "--history", report) == 0
    assert "<canvas" in (tmp_path / "v2.html").read_text()
    assert _cli("view", sp, tp, "-o", tmp_path / "v.png",
                "--history", report, "-k", "2") == 0
    assert (tmp_path / "v.png").stat().st_size > 10_000
    assert _cli("run", sp, tp, "--max-iterations", "5", "--nn-backend",
                "bruteforce", "--resume", tmp_path / "ck.json") == 0
    assert "resuming from iteration 10" in capsys.readouterr().out
    from iterativeclosestpoint_tpu_torch.runtime import smoke

    # The smoke check's own shape (16,384 x 50,000) takes ~20 s here.
    small = smoke.kernel_smoke
    monkeypatch.setattr(smoke, "kernel_smoke",
                        lambda **kw: small(n=1024, m=6000, **kw))
    assert _cli("smoke") == 0
    out = capsys.readouterr().out
    assert "smoke[sweep]" in out and "smoke[zcol]" in out


@pytest.mark.parametrize("argv,said", [
    # The id keeps the ROADMAP item the verb was ported under.
    pytest.param(["bench"], "is_available() is false", id="argv0-P9"),
])
def test_cli_unported_exit_nonzero(capsys, monkeypatch, argv, said):
    """Every verb of the JAX package's ``icp`` is ported; ``bench`` on its
    default device (the card) without CUDA exits non-zero with the reason
    and prints no JSON line, rather than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli_main(argv) != 0
    out = capsys.readouterr()
    assert said in out.err and out.out == ""


@pytest.mark.parametrize("flags, said", [
    ([], "requires --parallel partition"),
    (["--parallel", "dp"], "requires --parallel partition"),
    (["--parallel", "partition", "--multiscale"], "--multiscale"),
    (["--parallel", "partition", "-o", "reg.las"], "-o/--output"),
    (["--parallel", "partition", "--voxel", "0.5"], "--voxel"),
    (["--parallel", "partition", "--live-every", "2"], "--live-every"),
])
def test_cli_ingest_input_checks(capsys, flags, said):
    """``run --ingest`` exits 1 on the options the JAX CLI rejects
    (cli.py:66-80, :227-231), before reading a file, as the JAX CLI
    does."""
    from iterativeclosestpoint_tpu.cli import main as jax_cli_main

    argv = ["run", "s.las", "t.las", "--ingest", *flags]
    assert cli_main(["--device", "cpu", *argv]) == 1
    assert said in capsys.readouterr().out
    assert jax_cli_main(argv) == 1
    assert said in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["graph", "--loop", "--parallel", "dp"],
    ["run", "--parallel", "dp"],
    ["run", "--parallel", "partition"],
])
def test_cli_parallel_runs(tmp_path, capsys, argv):
    """``--parallel dp|partition`` runs over a 1-rank CPU mesh (one rank
    per visible card; ``--device cpu`` gives one CPU rank): ``run`` gives
    the session's transform for the same mode bit for bit, ``graph`` the
    edge-sharded pose graph within 1e-9 of the single-device solve."""
    sp, tp = _pair_files(tmp_path)
    verb, *flags = argv
    mode = flags[-1]
    if verb == "graph":
        out = tmp_path / "poses.json"
        assert _cli("graph", sp, tp, *flags, "--max-iterations", 5,
                    "--poses", out) == 0
        assert f"parallel={mode}: 1-rank mesh" in capsys.readouterr().out
        assert _cli("graph", sp, tp, "--loop", "--max-iterations", 5,
                    "--poses", tmp_path / "one.json") == 0
        got = np.asarray(json.loads(out.read_text())["poses"])
        ref = np.asarray(json.loads(
            (tmp_path / "one.json").read_text())["poses"])
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9)
        return
    rc = _cli("run", sp, tp, *flags, "--max-iterations", 5,
              "--nn-backend", "bruteforce", "-o", tmp_path / "reg.las")
    assert rc == 0
    assert f"parallel={mode}" in capsys.readouterr().out
    doc = json.loads((tmp_path / "reg_transform.json").read_text())
    sess, _ = _sessions(sp, tp)
    ref = sess.run(config=ICPConfig(max_iterations=5,
                                    nn_backend="bruteforce"), parallel=mode)
    np.testing.assert_array_equal(np.asarray(doc["transform"]),
                                  ref.transform)


def test_trace_writes_on_cpu(tmp_path):
    from iterativeclosestpoint_tpu_torch import icp_register
    from iterativeclosestpoint_tpu_torch.runtime.profiling import trace

    src, tgt, _ = make_registration_pair(n=500, seed=1)
    with trace(str(tmp_path / "prof")) as prof:
        icp_register(src, tgt, max_iterations=2, device="cpu")
    assert prof is not None
    data = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert data["traceEvents"]
    with trace(None) as none:
        assert none is None


def test_issue_floor_reports():
    from iterativeclosestpoint_tpu_torch.runtime.profiling import (
        CardSpec,
        KernelReport,
        nn_kernel_report,
    )

    h100 = CardSpec("NVIDIA H100 80GB HBM3", 132, 1.98e9)
    assert h100.issue_rate == pytest.approx(3.345e13, rel=1e-3)
    r = nn_kernel_report(1_000_000, 128, 4, 768, elapsed_s=5e-4, card=h100)
    assert r.pairs == 7813 * 128 * 4 * 768
    assert r.floor_s == pytest.approx(r.pairs * 9 / h100.issue_rate)
    assert 0 < r.share < 2 and "of the floor" in r.line()
    k3 = KernelReport("K3", 3.748e-4, 29_412.0**2, h100)
    assert k3.share == pytest.approx(0.621, abs=0.01)  # PERF.md's K3 row
