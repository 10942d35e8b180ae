"""Port parity: the streamed LAS ingest (``parallel/ingest.py``), in
process against the JAX package's on as many of the conftest's virtual
devices as the port's CPU mesh has ranks (mirrors
``tests/test_partition.py``'s ingest tests, ``tests/test_sharded.py::
test_sharded_ingest_from_file`` and ``tests/test_runtime.py::
test_cli_run_partition_ingest``).

Tolerances and why:

* the header offset, the strided samples and walls, the sampled grid
  parameters, each rank's retained slab rows with their original indices
  and the sharded source blocks: exact (the same numpy operations on the
  same bytes; the port's slabs hold the JAX buffers' real rows);
* per-slab plane normals: |cos| ≥ 0.9999 but for a handful of rows (the
  port sums each cell's moments exactly in fixed point, JAX in f32: on
  near-isotropic cells the smallest eigenvector moves; ROADMAP §3);
* the coarse cold start and the f32 partitioned runs (point and plane):
  JAX's iterations and stop code, and 1e-4 m of registration error (the
  f32 gate of PARITY.md);
* the port's run from ``partition_state_from_numpy`` of JAX's state and
  from its own loader: bit for bit (the same rows in the same order);
* ``icp-torch run --parallel partition --ingest`` against the library
  sequence it runs: bit for bit; against the JAX CLI: 1e-4 m.

About 40 s alone on one worker.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from iterativeclosestpoint_tpu.cli import main as jax_cli_main
from iterativeclosestpoint_tpu.io.las import write_las
from iterativeclosestpoint_tpu.parallel import ingest as jing
from iterativeclosestpoint_tpu.parallel import partition as jpart
from iterativeclosestpoint_tpu.parallel.mesh import make_mesh as jax_mesh
from iterativeclosestpoint_tpu.utils.synth import (
    apply_transform_np,
    make_cloud,
    make_registration_pair,
)
from iterativeclosestpoint_tpu_torch.cli import main as cli_main
from iterativeclosestpoint_tpu_torch.convert import (
    partition_state_from_numpy,
)
from iterativeclosestpoint_tpu_torch.io.las import read_header
from iterativeclosestpoint_tpu_torch.parallel import ingest as ting
from iterativeclosestpoint_tpu_torch.parallel import (
    icp_register_partitioned,
    make_mesh,
)
from iterativeclosestpoint_tpu_torch.parallel.partition import (
    _IMAX,
    fill_partition_normals,
)

F64 = torch.float64


def _mesh(n):
    return make_mesh(devices=["cpu"] * n)


def _reg_err(Ta, Tb, pts):
    return float(np.abs(apply_transform_np(Ta, pts)
                        - apply_transform_np(Tb, pts)).max())


def _files(tmp_path, src, tgt):
    sp, tp = tmp_path / "s.las", tmp_path / "t.las"
    write_las(sp, src)
    write_las(tp, tgt)
    return sp, tp


def _clustered():
    """Two dense clusters and a sparse tail: the walls leave a slab
    nearly empty (``test_partition.py``'s edge case)."""
    rng = np.random.default_rng(9)
    tgt = np.concatenate([
        rng.normal([0, 0, 0], 0.5, (1500, 3)),
        rng.normal([10, 0, 0], 0.5, (1500, 3)),
        rng.uniform(-1, 11, (20, 3)),
    ])
    src = (tgt - np.array([0.08, -0.05, 0.03])
           + rng.normal(0, 0.005, tgt.shape))
    return src, tgt


def test_samples_walls_and_grid_params_match_jax(tmp_path):
    tgt = make_cloud(60_000, seed=9)
    _, tp = _files(tmp_path, tgt[:10], tgt)
    hdr = read_header(tp)
    np.testing.assert_array_equal(
        ting.header_center(hdr), jing.header_center(jing.read_header(tp)))
    for n_dev in (1, 4):
        w_t, _ = ting.sample_x_walls(tp, n_dev, sample_cap=8_000)
        w_j, _ = jing.sample_x_walls(tp, n_dev, sample_cap=8_000)
        np.testing.assert_array_equal(w_t, w_j)
    s_t, _ = ting.sample_points(tp, sample_cap=8_000, chunk=7_000)
    s_j, _ = jing.sample_points(tp, sample_cap=8_000, chunk=7_000)
    np.testing.assert_array_equal(s_t, s_j)
    for kw in (dict(), dict(grid_resolution=16), dict(fine_kernel="zcol")):
        gp_t = ting.estimate_partition_grid_params(tp, w_t, 1.0,
                                                   sample_cap=8_000, **kw)
        gp_j = jing.estimate_partition_grid_params(tp, w_j, 1.0,
                                                   sample_cap=8_000, **kw)
        assert gp_t == gp_j, kw


@pytest.mark.parametrize("cloud", ["terrain", "clustered"])
def test_loaders_match_jax(tmp_path, cloud):
    """Each rank's slab rows and original indices, the walls and limits,
    the wall-sharded source and the stats: the JAX per-device buffers'
    real rows, exactly."""
    if cloud == "terrain":
        src, tgt, _ = make_registration_pair(n=4001, seed=135,
                                             noise_sigma=0.02)
        halo, batch = 2.0, 1000
    else:
        src, tgt = _clustered()
        halo, batch = 0.5, 700
    sp, tp = _files(tmp_path, src, tgt)
    offset = ting.header_center(read_header(tp))
    mesh, jmesh = _mesh(4), jax_mesh(4)
    t_stats, j_stats = {}, {}
    part, walls = ting.load_las_partitioned_target(
        tp, mesh, halo=halo, offset=offset, dtype=F64, batch_size=batch,
        stats=t_stats)
    jp, jwalls = jing.load_las_partitioned_target(
        tp, jmesh, halo=halo, offset=offset, dtype=np.float64,
        batch_size=batch, stats=j_stats)
    np.testing.assert_array_equal(walls, jwalls)
    assert t_stats == j_stats
    j_pts, j_idx = np.asarray(jp.halo_pts), np.asarray(jp.halo_idx)
    np.testing.assert_array_equal(part.x_lo, np.asarray(jp.x_lo))
    np.testing.assert_array_equal(part.x_hi, np.asarray(jp.x_hi))
    for r in range(4):
        real = j_idx[r] != _IMAX
        if real.any():
            np.testing.assert_array_equal(part.halo_pts[r].numpy(),
                                          j_pts[r][real])
            np.testing.assert_array_equal(part.halo_idx[r].numpy(),
                                          j_idx[r][real])
        else:  # an empty slab: one far row no real row loses to
            assert part.halo_idx[r].tolist() == [_IMAX]

    t_stats, j_stats = {}, {}
    shards, weights, n_rows = ting.load_las_partitioned_source(
        sp, mesh, walls=walls, offset=offset, dtype=F64, batch_size=batch,
        stats=t_stats)
    js, jw, jn = jing.load_las_partitioned_source(
        sp, jmesh, walls=jwalls, offset=offset, dtype=np.float64,
        batch_size=batch, stats=j_stats)
    assert n_rows == jn == len(src) and t_stats == j_stats
    js, jw = np.asarray(js).reshape(4, -1, 3), np.asarray(jw).reshape(4, -1)
    for r in range(4):
        c = int(jw[r].sum())
        w = weights[r].numpy()
        assert len(w) == jw.shape[1] and w.sum() == c
        np.testing.assert_array_equal(shards[r].numpy()[:c], js[r][:c])


def test_sharded_loader_matches_jax(tmp_path):
    src, tgt, _ = make_registration_pair(n=1001, seed=50, noise_sigma=0.02)
    sp, tp = _files(tmp_path, src, tgt)
    offset = jing.header_center(jing.read_header(tp))
    t_stats, j_stats = {}, {}
    shards, weights, n, _ = ting.load_las_sharded(
        sp, _mesh(4), offset=offset, dtype=F64, stats=t_stats)
    js, jw, jn, _ = jing.load_las_sharded(
        sp, jax_mesh(4), offset=offset, dtype=np.float64, stats=j_stats)
    assert n == jn and t_stats == j_stats
    np.testing.assert_array_equal(torch.cat(shards).numpy(), np.asarray(js))
    np.testing.assert_array_equal(torch.cat(weights).numpy(), np.asarray(jw))


@pytest.mark.parametrize("estimator", ["point", "plane"])
def test_partitioned_ingest_run_matches_jax(tmp_path, estimator):
    """The f32 ingest run (brute local search) against JAX's on the same
    files; the port's run from JAX's own state is bit-equal to its run
    from its own loader. Plane mode holds the per-slab normals too."""
    src, tgt, _ = make_registration_pair(n=4001, seed=135, noise_sigma=0.02)
    sp, tp = _files(tmp_path, src, tgt)
    offset = ting.header_center(read_header(tp))
    mesh, jmesh = _mesh(4), jax_mesh(4)
    part, walls = ting.load_las_partitioned_target(
        tp, mesh, halo=2.0, offset=offset, batch_size=1000)
    src_g = ting.load_las_partitioned_source(
        sp, mesh, walls=walls, offset=offset, batch_size=1000)
    jp, jwalls = jing.load_las_partitioned_target(
        tp, jmesh, halo=2.0, offset=offset, batch_size=1000)
    js = jing.load_las_partitioned_source(
        sp, jmesh, walls=jwalls, offset=offset, batch_size=1000)
    kw = dict(offset=offset, estimator=estimator, max_iterations=15,
              return_registered=False)
    res = icp_register_partitioned(None, None, mesh=mesh,
                                   partition_state=part, source_global=src_g,
                                   **kw)
    jres = jpart.icp_register_partitioned(
        None, None, mesh=jmesh, partition_state=jp, source_global=js,
        dtype=jnp.float32, **kw)
    assert res.iterations == jres.iterations
    assert res.stop_reason == jres.stop_reason
    assert _reg_err(res.transform, jres.transform, src) < 1e-4

    jd = {k: np.asarray(getattr(jp, k)) for k in jp._fields}
    conv = partition_state_from_numpy(jd, mesh)
    res2 = icp_register_partitioned(None, None, mesh=mesh,
                                    partition_state=conv,
                                    source_global=src_g, **kw)
    np.testing.assert_array_equal(res2.history_rmse, res.history_rmse)
    np.testing.assert_array_equal(res2.transform, res.transform)

    if estimator == "plane":
        t_n = fill_partition_normals(part, resolution=64)
        j_n = np.asarray(jpart.fill_partition_normals(
            jp, mesh=jmesh, resolution=64).halo_nrm)
        idx = np.asarray(jp.halo_idx)
        off = []
        for r in range(4):
            real = idx[r] != _IMAX
            cos = np.abs((t_n.halo_nrm[r].numpy().astype(np.float64)
                          * j_n[r][real]).sum(axis=1))
            off.append(int((cos < 0.9999).sum()))
        # Measured: 6 of the 4,482 slab rows, all on rank 1, the worst
        # 1.3° apart.
        assert sum(off) <= 8, off


def test_coarse_carry_matches_jax(tmp_path):
    src, tgt, _ = make_registration_pair(n=5001, seed=61, noise_sigma=0.01)
    sp, tp = _files(tmp_path, src, tgt)
    c_t = ting.coarse_carry_from_files(sp, tp, sample_cap=1500,
                                       max_iterations=40, tolerance=1e-7,
                                       device="cpu")
    c_j = jing.coarse_carry_from_files(sp, tp, sample_cap=1500,
                                       max_iterations=40, tolerance=1e-7)
    assert c_t.keys() == c_j.keys()
    assert (c_t["prev_error"], c_t["no_improve"]) == (1e10, 0)
    assert _reg_err(c_t["transform"], c_j["transform"], src) < 1e-4


def test_cli_run_partition_ingest(tmp_path, capsys):
    """``icp-torch --device cpu run --parallel partition --ingest``: its
    stages, report, checkpoint, history and metrics; its transform is the
    library sequence's bit for bit, and within 1e-4 m of the JAX CLI's."""
    src, tgt, T_true = make_registration_pair(n=5001, seed=62,
                                              noise_sigma=0.01)
    sp, tp = _files(tmp_path, src, tgt)
    out = {}
    for name, main, pre in (("port", cli_main, ["--device", "cpu"]),
                            ("jax", jax_cli_main, [])):
        d = tmp_path / name
        d.mkdir()
        rc = main([*pre, "run", str(sp), str(tp), "--parallel",
                   "partition", "--ingest", "--report", str(d / "r.txt"),
                   "--checkpoint", str(d / "ck.json"),
                   "--history", str(d / "h.jsonl"),
                   "--metrics", str(d / "m.jsonl"),
                   "--max-iterations", "40", "--tolerance", "1e-7"])
        said = capsys.readouterr().out
        assert rc == 0, said
        for stage in ("ingest-partitioned:", "coarse sample alignment done",
                      "sampled grid params:", "streamed ingest done",
                      "registration finished"):
            assert stage in said, (name, said)
        rec = json.loads((d / "h.jsonl").read_text().splitlines()[-1])
        assert rec["success"] and rec["iterations"] >= 1
        assert (d / "r.txt").exists() and (d / "r.json").exists()
        assert (d / "m.jsonl").read_text().count('"iteration"') >= 1
        out[name] = np.asarray(
            json.loads((d / "ck.json").read_text())["transform"])
    assert _reg_err(out["port"], T_true, src) < 5e-2
    assert _reg_err(out["port"], out["jax"], src) < 1e-4

    # The library sequence the command runs, on its one CPU rank.
    mesh = make_mesh(device="cpu")
    hdr_t, hdr_s = read_header(tp), read_header(sp)
    offset = ting.header_center(hdr_t)
    halo = 0.02 * float(np.max(np.asarray(hdr_t.bounds_max)
                               - np.asarray(hdr_t.bounds_min)))
    s_tgt, _ = ting.sample_points(tp, header=hdr_t)
    s_src, _ = ting.sample_points(sp, header=hdr_s)
    walls = np.quantile(s_tgt[:, 0], np.linspace(0, 1, 2))
    walls[0], walls[-1] = -np.inf, np.inf
    carry = ting.coarse_carry_from_files(sp, tp, tolerance=1e-7,
                                         samples=(s_src, s_tgt),
                                         device="cpu")
    gp = ting.estimate_partition_grid_params(
        tp, walls, halo, header=hdr_t, n_queries_hint=hdr_s.point_count,
        sample=s_tgt)
    part, walls = ting.load_las_partitioned_target(
        tp, mesh, halo=halo, offset=offset, walls=walls)
    src_g = ting.load_las_partitioned_source(sp, mesh, walls=walls,
                                             offset=offset)
    res = icp_register_partitioned(
        None, None, mesh=mesh, partition_state=part, source_global=src_g,
        offset=offset, grid_params=gp, resume_carry=carry,
        max_iterations=40, tolerance=1e-7, return_registered=False)
    np.testing.assert_array_equal(res.transform, out["port"])
