"""Port parity: settings, checkpoints, metrics, reports, viewers and stage
timing against the JAX package on the same inputs. Mirrors
``test_runtime.py``'s record tests, ``test_htmlviz.py`` and
``test_timing.py``.

These are host writers, so the bar is identity: the same inputs give the
same JSON text, report text and HTML bytes in both packages (metrics JSONL
up to its wall-clock timestamps), and a file written by either package
loads in the other. ``iteration_records`` is held against the JAX
method on the same f64 brute-force run at 1e-9, the oracle gate.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from iterativeclosestpoint_tpu.models.icp import icp_register as jax_icp
from iterativeclosestpoint_tpu.runtime import checkpoint as jck
from iterativeclosestpoint_tpu.runtime import htmlviz as jhtml
from iterativeclosestpoint_tpu.runtime import metrics as jmet
from iterativeclosestpoint_tpu.utils import config as jcfg
from iterativeclosestpoint_tpu.utils.synth import make_registration_pair
from iterativeclosestpoint_tpu_torch import icp_register
from iterativeclosestpoint_tpu_torch.models.icp import ICPResult
from iterativeclosestpoint_tpu_torch.runtime import checkpoint as tck
from iterativeclosestpoint_tpu_torch.runtime import htmlviz as thtml
from iterativeclosestpoint_tpu_torch.runtime import metrics as tmet
from iterativeclosestpoint_tpu_torch.runtime.timing import (
    StageCollector,
    active,
    collect,
    scope,
    stage,
)
from iterativeclosestpoint_tpu_torch.utils import config as tcfg


@pytest.fixture(scope="module")
def runs():
    """The same f64 brute-force run in both packages: (port, JAX, src,
    tgt)."""
    src, tgt, _ = make_registration_pair(n=1500, seed=31, noise_sigma=0.01)
    kw = dict(max_iterations=8, nn_backend="bruteforce", tolerance=1e-10)
    res = icp_register(src, tgt, dtype=torch.float64, device="cpu", **kw)
    ref = jax_icp(src, tgt, dtype=jnp.float64, **kw)
    return res, ref, src, tgt


def _as_port(ref):
    """The JAX result's values in the port's ICPResult, so the writers of
    the two packages see the very same numbers."""
    return ICPResult(**{f.name: getattr(ref, f.name)
                        for f in dataclasses.fields(ICPResult)})


def test_iteration_records_match_jax(runs):
    res, ref, _, _ = runs
    a, b = res.iteration_records(), ref.iteration_records()
    assert res.iterations == ref.iterations == len(a) == len(b)
    for ra, rb in zip(a, b):
        assert list(ra) == list(rb)  # same keys in the same order
        for k in ra:
            assert type(ra[k]) is type(rb[k]), k
            np.testing.assert_allclose(ra[k], rb[k], rtol=1e-9, atol=1e-9,
                                       err_msg=k)


@pytest.mark.parametrize("icp", [
    {}, dict(max_iterations=77, nn_backend="pallas", cell_capacity=20),
    dict(estimator="plane", robust="tukey", grid_resolution=64, mode="cli"),
])
def test_settings_json_identical_and_shared(tmp_path, icp):
    a = tcfg.AppSettings(icp=tcfg.ICPConfig(**icp), point_size=3.0)
    b = jcfg.AppSettings(icp=jcfg.ICPConfig(**icp), point_size=3.0)
    a.save(tmp_path / "t.json")
    b.save(tmp_path / "j.json")
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    assert (jcfg.AppSettings.load(tmp_path / "t.json").to_dict()
            == tcfg.AppSettings.load(tmp_path / "j.json").to_dict())
    assert tcfg.default_settings_path() == jcfg.default_settings_path()


@pytest.mark.parametrize("bad", [
    dict(max_iterations=0), dict(tolerance=0.5), dict(sigma_multiplier=9.0),
    dict(cell_capacity=4), dict(grid_resolution=7), dict(mode="x"),
    dict(nn_backend="kd"), dict(estimator="line"), dict(robust="cauchy"),
])
def test_config_validate_identical(bad):
    with pytest.raises(ValueError) as ea:
        tcfg.ICPConfig(**bad).validate()
    with pytest.raises(ValueError) as eb:
        jcfg.ICPConfig(**bad).validate()
    assert str(ea.value) == str(eb.value)


@pytest.mark.parametrize("carry", [True, False])
def test_checkpoint_json_identical_and_shared(tmp_path, runs, carry):
    _, ref, _, _ = runs
    kw = dict(iteration=ref.iterations, transform=ref.transform,
              rmse_history=ref.history_rmse, config={"max_iterations": 8},
              source_path="s.las", target_path="t.las")
    if carry:
        kw.update(prev_error=ref.carry_prev_error,
                  no_improve=ref.carry_no_improve,
                  transform_local=ref.carry_transform_local,
                  center_offset=ref.center_offset)
    tck.save_checkpoint(tmp_path / "t.json", **kw)
    jck.save_checkpoint(tmp_path / "j.json", **kw)
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    a, b = jck.load_checkpoint(tmp_path / "t.json"), tck.load_checkpoint(
        tmp_path / "j.json")
    pa, pb = (m.resume_arguments(d, 20) for m, d in ((jck, a), (tck, b)))
    assert pa.keys() == pb.keys()
    assert ("resume_carry" in pa) == carry
    flat = lambda p: {k: v for k, v in (p.get("resume_carry") or p).items()}
    for k, v in flat(pa).items():
        np.testing.assert_array_equal(v, flat(pb)[k])


def test_metrics_jsonl_equal_but_timestamps(tmp_path, runs):
    _, ref, _, _ = runs
    for mod, name in ((tmet, "t"), (jmet, "j")):
        m = mod.MetricsWriter(jsonl_path=tmp_path / f"{name}.jsonl",
                              console=False)
        for rec in ref.iteration_records():
            m.iteration(rec, 8)
        m.event("run", success=True, rmse=float(ref.rmse), iterations=8)
        m.close()
    rows = [[{k: v for k, v in json.loads(line).items() if k != "ts"}
             for line in (tmp_path / f"{n}.jsonl").read_text().splitlines()]
            for n in ("t", "j")]
    assert rows[0] == rows[1] and len(rows[0]) == ref.iterations + 1


def test_metrics_console_line(runs):
    import io

    _, ref, _, _ = runs
    out = []
    for mod in (tmet, jmet):
        s = io.StringIO()
        mod.MetricsWriter(console=True, stream=s).iteration(
            ref.iteration_records()[0], 8)
        out.append(s.getvalue().split("] ", 1)[1])
    assert out[0] == out[1] and "iteration 1/8" in out[0]


@pytest.mark.parametrize("history", [True, False])
def test_report_and_history_json_identical(tmp_path, runs, history):
    _, ref, _, _ = runs
    port = _as_port(ref)
    tmet.write_transform_report(tmp_path / "t.txt", port,
                                include_history=history)
    jmet.write_transform_report(tmp_path / "j.txt", ref,
                                include_history=history)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    tmet.write_history_json(tmp_path / "t.json", port)
    jmet.write_history_json(tmp_path / "j.json", ref)
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    a = tmet.read_history_json(tmp_path / "j.json")
    b = jmet.read_history_json(tmp_path / "t.json")
    np.testing.assert_array_equal(a["transform"], b["transform"])
    for ra, rb in zip(a["history"], b["history"]):
        np.testing.assert_array_equal(ra["transform"], rb["transform"])


def test_history_json_from_port_run(tmp_path, runs):
    """The port's own run written by both packages' writers: the JAX
    writer reads the port's result through the same methods."""
    res, _, _, _ = runs
    tmet.write_history_json(tmp_path / "t.json", res)
    jmet.write_history_json(tmp_path / "j.json", res)
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()


@pytest.mark.parametrize("kind", ["replay", "live", "capped", "scene"])
def test_html_bytes_identical(tmp_path, runs, kind):
    _, ref, src, tgt = runs
    hist = ref.iteration_records()
    for mod, name in ((thtml, "t"), (jhtml, "j")):
        path = tmp_path / f"{name}.html"
        if kind == "scene":
            mod.export_scene_html(path, [src, tgt, src + 5.0],
                                  names=["a", "b", "c"], title="scene",
                                  max_points=800)
        else:
            mod.export_interactive_html(
                path, src, tgt, history=hist if kind != "capped" else None,
                title="</script> pair", max_points=700 if kind == "capped"
                else 400_000, refresh_s=3.0 if kind == "live" else 0.0)
    assert (tmp_path / "t.html").read_bytes() == (tmp_path / "j.html").read_bytes()


def test_png_written(tmp_path):
    from iterativeclosestpoint_tpu_torch.runtime.viz import (
        render_registration_png,
    )

    src, tgt, _ = make_registration_pair(n=500, seed=120)
    p = tmp_path / "v.png"
    render_registration_png(p, src, tgt,
                            rmse_history=np.array([1.0, 0.5, 0.2]))
    assert p.exists() and p.stat().st_size > 10_000


def test_stage_noop_without_collector():
    assert active() is None
    with stage("anything") as done:
        done(torch.ones(3))  # must be a no-op, not an error
    assert active() is None


def test_collect_records_stages_and_scopes():
    with collect(sync=True) as col:
        with stage("upload", bytes=1000) as done:
            x = torch.arange(8.0)
            done(x)
        with scope("fine"):
            with stage("loop") as done:
                y = x * 2
                done(y)
    assert "upload" in col.stages and col.stages["upload"] >= 0
    assert col.meta["upload"]["bytes"] == 1000
    assert "fine/loop" in col.stages
    assert col.stages["fine"] >= col.stages["fine/loop"]
    lines = col.lines()
    assert any(line.startswith("upload:") and "MB" in line for line in lines)
    assert active() is None  # context restored


def test_stage_accumulates_across_calls():
    with collect(sync=False) as col:
        for _ in range(3):
            with stage("upload", bytes=10):
                pass
    assert col.meta["upload"]["bytes"] == 30


def test_drain_handles_host_only_structures():
    with collect(sync=True) as col:
        with stage("host") as done:
            done({"a": np.ones(3), "b": [torch.ones(2), 1.0]})
    assert "host" in col.stages


def test_collector_exception_restores_context():
    with pytest.raises(RuntimeError):
        with collect(sync=False):
            assert isinstance(active(), StageCollector)
            raise RuntimeError("boom")
    assert active() is None
