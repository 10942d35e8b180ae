"""A level's prep on the device (``models/prep.py::prepare_level``): the
f64 clouds uploaded as they are, centred and cast where they live, and the
grid factory's box taken from the uploaded target
(``ops/sweep_nn.py::make_pallas_nn_device`` with no host cloud).

Everything is held bit for bit against the numpy prep it replaced: the
device inputs and the offset (UTM-scale clouds, rows on an f32 rounding
tie, non-finite rows), the factory's grids and configuration, and whole
registrations: the multiscale fine level (point, and plane's two-stage
fine level) against its numpy prep, and ``icp_register`` against its
former host path (``center_offset``, the f64 subtract, an upload in the
loop's dtype and the NN factory of every backend). The spans that
``host_prep_ms`` reads are all recorded, with the prep's counters.
"""

import functools
import json

import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from iterativeclosestpoint_tpu_torch import (
    icp_register,
    icp_register_multiscale,
)
from iterativeclosestpoint_tpu_torch.cli import main as cli_main
from iterativeclosestpoint_tpu_torch.models import icp, multiscale, prep
from iterativeclosestpoint_tpu_torch.models.prep import (
    _brute_adapter,
    _brute_plane_adapter,
    prepare_level,
)
from iterativeclosestpoint_tpu_torch.ops.cellblock import (
    auto_resolution_data,
    make_cellblock_nn,
    morton_order,
)
from iterativeclosestpoint_tpu_torch.ops.hashgrid import make_hashgrid_nn
from iterativeclosestpoint_tpu_torch.ops.normals import (
    estimate_normals_cellpca,
)
from iterativeclosestpoint_tpu_torch.ops.sweep_grid import (
    grouped_tile_order_device,
)
from iterativeclosestpoint_tpu_torch.ops.sweep_nn import make_pallas_nn_device
from iterativeclosestpoint_tpu_torch.ops.sweep_params import (
    estimate_fine_grid_device,
)
from iterativeclosestpoint_tpu_torch.runtime import session
from iterativeclosestpoint_tpu_torch.runtime.timing import collect, stage
from iterativeclosestpoint_tpu_torch.utils.hostmath import center_offset
from iterativeclosestpoint_tpu_torch.utils.synth import make_registration_pair

CPU = torch.device("cpu")
UTM = np.array([500_000.0, 5_400_000.0, 250.0])


def _numpy_prepare_fine(source, target, fine_kwargs, dev, two_stage=True):
    """The fine prep as the host computed it before it moved to the device:
    numpy centring and casts, an f32 upload, the factory's host box."""
    offset = (center_offset(target) if fine_kwargs.get("center", True)
              else np.zeros(3))
    src_local = (source - offset).astype(np.float32)
    tgt_local = (target - offset).astype(np.float32)
    src_dev = torch.as_tensor(src_local, device=dev)
    tgt_dev = torch.as_tensor(tgt_local, device=dev)
    plane = fine_kwargs.get("estimator", "point") == "plane"
    grid_est, boost2_est = estimate_fine_grid_device(
        tgt_dev, fine_kwargs.get("grid_resolution"), plane=plane,
        two_stage=two_stage)
    prepared_nn = make_pallas_nn_device(
        tgt_local, target_dev=tgt_dev, est=grid_est, with_normals=plane)
    prepared_nn2 = None
    if boost2_est is not None:
        prepared_nn2 = make_pallas_nn_device(
            tgt_local, target_dev=tgt_dev, est=boost2_est,
            with_normals=True, normals=prepared_nn[1][2])
    return (src_dev, tgt_dev, offset), prepared_nn, prepared_nn2


def _parent_default_nn(nn_backend, source_local, target_local,
                       grid_resolution, cell_capacity=None, *,
                       estimator="point", source_dev, target_dev):
    """``icp_register``'s NN factory before every level's prep moved to the
    device (``models/icp.py::_default_nn``), as it was: the host clouds are
    f64, ``source_dev`` and ``target_dev`` their uploads. Returns (nn_fn,
    nn_state, rows | None, weight | None, resolution | None)."""
    m = len(target_local)
    n = len(source_local)
    if nn_backend == "auto":
        nn_backend = "bruteforce" if n * m <= 2**31 else "pallas"
    if estimator == "plane" and nn_backend not in ("bruteforce", "pallas"):
        raise ValueError(
            "estimator='plane' supports nn_backend 'bruteforce' or 'pallas'")
    if nn_backend == "bruteforce":
        if estimator == "plane":
            nrm = estimate_normals_cellpca(
                target_local, auto_resolution_data(target_local))
            return (_brute_plane_adapter,
                    torch.as_tensor(nrm, dtype=target_dev.dtype,
                                    device=target_dev.device),
                    None, None, None)
        return _brute_adapter, (), None, None, None
    if nn_backend == "cellblock":
        nn_fn, grid, resolution = make_cellblock_nn(
            target_local, resolution=grid_resolution or None,
            dtype=target_dev.dtype, device=target_dev.device)
        rows = torch.as_tensor(morton_order(source_local, resolution),
                               device=target_dev.device)
        return nn_fn, grid, rows, None, resolution
    if nn_backend == "hashgrid":
        resolution = grid_resolution or 64
        nn_fn, grid = make_hashgrid_nn(
            target_local, resolution=resolution, capacity=cell_capacity,
            dtype=target_dev.dtype, device=target_dev.device)
        return nn_fn, grid, None, None, resolution
    if nn_backend == "pallas":
        nn_fn, state, resolution = make_pallas_nn_device(
            target_local, resolution=grid_resolution, target_dev=target_dev,
            with_normals=estimator == "plane",
        )
        rows, weight = grouped_tile_order_device(
            source_dev, state[0].origin, state[0].cell_size,
            resolution=resolution, tile_q=nn_fn.tile_q,
            group=nn_fn.layout_group,
        )
        return nn_fn, state, rows, weight, resolution
    raise ValueError(f"unknown nn_backend {nn_backend!r}")


def _parent_prepare_level(source, target, device, *, dtype=torch.float32,
                          center=True, nn_backend=None, estimator="point",
                          grid_resolution=None, cell_capacity=None,
                          two_stage=False, device_data=None):
    """``icp_register``'s former host prep in ``prepare_level``'s
    contract: numpy's ``center_offset`` and f64 subtract, an upload in the
    loop's dtype, and ``_parent_default_nn``. Its sweep layout is dropped:
    ``icp_register`` makes the same call on the same source from the
    factory's grid."""
    assert device_data is None and not two_stage
    offset = center_offset(target) if center else np.zeros(3)
    src_np = source - offset
    tgt_np = target - offset
    src_dev = torch.as_tensor(src_np, dtype=dtype, device=device)
    tgt_dev = torch.as_tensor(tgt_np, dtype=dtype, device=device)
    data = (src_dev, tgt_dev, offset)
    if nn_backend is None:
        return data, None, None, None
    nn_fn, state, rows, _, res = _parent_default_nn(
        nn_backend, src_np, tgt_np, grid_resolution, cell_capacity,
        estimator=estimator, source_dev=src_dev, target_dev=tgt_dev)
    if hasattr(nn_fn, "layout_group"):
        rows = None
    return data, (nn_fn, state, res), None, rows


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


def _stub_grids(monkeypatch):
    """The grid stages off: they read only ``tgt_dev``."""
    monkeypatch.setattr(prep, "estimate_fine_grid_device",
                        lambda *a, **k: (None, None))
    monkeypatch.setattr(prep, "make_pallas_nn_device",
                        lambda *a, **k: None)


def _assert_prep_bit_equal(src, tgt, monkeypatch, center=True, dev=CPU):
    """``prepare_level``'s device clouds and offset against numpy's."""
    _stub_grids(monkeypatch)
    (src_dev, tgt_dev, offset), _, _, _ = prepare_level(
        src, tgt, dev, center=center, nn_backend="pallas")
    want = center_offset(tgt) if center else np.zeros(3)
    assert offset.dtype == np.float64
    assert np.array_equal(_bits(offset), _bits(want))
    for got, x in ((src_dev, src), (tgt_dev, tgt)):
        assert got.dtype == torch.float32 and got.device.type == dev.type
        with np.errstate(invalid="ignore"):  # inf - inf in the reference
            ref = (x - want).astype(np.float32)
        assert np.array_equal(_bits(got.cpu().numpy()), _bits(ref))


def _utm_pair(n, seed):
    rng = np.random.default_rng(seed)
    tgt = rng.uniform(0.0, 200.0, (n, 3)) * [1.0, 1.0, 0.2] + UTM
    src = tgt[rng.permutation(n)] + rng.normal(0.0, 0.3, (n, 3))
    return src, tgt


@pytest.mark.parametrize("n, seed", [(20_000, 1), (75_000, 2),
                                     (200_000, 3)])
@pytest.mark.parametrize("center", [True, False])
def test_prep_bit_equal_on_utm_clouds(n, seed, center, monkeypatch):
    src, tgt = _utm_pair(n, seed)
    _assert_prep_bit_equal(src, tgt, monkeypatch, center=center)


def test_prep_bit_equal_on_f32_rounding_ties(monkeypatch):
    """Source rows whose centred f64 value lies halfway between two f32
    values round to the even one, on the device as in numpy."""
    rng = np.random.default_rng(7)
    lo, hi = UTM, UTM + [200.0, 200.0, 40.0]
    tgt = np.concatenate([[lo, hi], rng.uniform(lo, hi, (20_000, 3))])
    off = center_offset(tgt)
    # |a| >= 1: the half ulp stays above the f64 ulp of a UTM northing.
    a = (rng.uniform(1.0, 100.0, (4_000, 3))
         * rng.choice([-1.0, 1.0], (4_000, 3))).astype(np.float32)
    b = np.nextafter(a, np.float32(np.inf))
    mid = (a.astype(np.float64) + b.astype(np.float64)) / 2
    src = off + mid
    assert np.array_equal(src - off, mid)  # each row centres to its tie
    got = (src - off).astype(np.float32)
    assert (got == a).any() and (got == b).any()  # ties go both ways
    _assert_prep_bit_equal(src, tgt, monkeypatch)


@pytest.mark.parametrize("where", ["source", "target"])
def test_prep_bit_equal_with_nonfinite_rows(where, monkeypatch):
    src, tgt = _utm_pair(20_000, 4)
    bad = src if where == "source" else tgt
    bad[5, 0], bad[6, 1], bad[7, 2] = np.nan, np.inf, -np.inf
    _assert_prep_bit_equal(src, tgt, monkeypatch)


def test_prep_copies_a_strided_cloud_once(monkeypatch):
    """A caller's non-contiguous array is copied once, a pass the counter
    shows; the contiguous one uploads as it is."""
    src, tgt = _utm_pair(40_000, 5)
    view = np.concatenate([src, src], axis=1)[:, :3]
    assert not view.flags.c_contiguous
    _stub_grids(monkeypatch)
    with collect(sync=False) as col:
        (src_dev, _, offset), _, _, _ = prepare_level(
            view, tgt, CPU, nn_backend="pallas")
    assert col.meta["host_prep"]["host_passes"] == 1
    assert col.meta["upload"]["bytes"] == 24 * (len(src) + len(tgt))
    assert np.array_equal(src_dev.numpy(),
                          (src - offset).astype(np.float32))


def _closure(fn):
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))


def _assert_factories_equal(a, b):
    (fa, sa, ra), (fb, sb, rb) = a, b
    assert ra == rb
    assert _closure(fa) == _closure(fb)
    assert (fa.tile_q, fa.with_normals, fa.layout_group) == (
        fb.tile_q, fb.with_normals, fb.layout_group)
    for ga, gb in zip(sa[:2], sb[:2]):
        assert type(ga) is type(gb)
        for x, y in zip(ga, gb):
            assert x.dtype == y.dtype and torch.equal(x, y)
    assert (sa[2] is None) == (sb[2] is None)
    if sa[2] is not None:
        assert torch.equal(sa[2], sb[2])


@pytest.mark.parametrize("kind, estimator", [("terrain", "point"),
                                             ("terrain", "plane"),
                                             ("uniform", "point")])
def test_factory_box_from_the_device(kind, estimator):
    """With no host cloud the factory builds what it builds from the host
    cloud: grids, origin, cell sizes, trange, resolution, the nn_fn."""
    _, tgt, _ = make_registration_pair(n=50_000, seed=9, kind=kind,
                                       extent=100.0)
    tgt = tgt + UTM
    tgt_local = (tgt - center_offset(tgt)).astype(np.float32)
    tgt_dev = torch.as_tensor(tgt_local)
    plane = estimator == "plane"
    est, boost2 = estimate_fine_grid_device(tgt_dev, None, plane=plane)
    with collect(sync=False) as col:
        with stage("grid_build"):
            got = make_pallas_nn_device(None, target_dev=tgt_dev, est=est,
                                        with_normals=plane)
    want = make_pallas_nn_device(tgt_local, target_dev=tgt_dev, est=est,
                                 with_normals=plane)
    _assert_factories_equal(got, want)
    assert col.meta["grid_build"]["prep_reads"] == 1
    assert "host_passes" not in col.meta["grid_build"]
    assert got[0].layout_group == ("xy" if kind == "uniform" else "x")
    if boost2 is not None:
        _assert_factories_equal(
            make_pallas_nn_device(None, target_dev=tgt_dev, est=boost2,
                                  with_normals=True, normals=got[1][2]),
            make_pallas_nn_device(tgt_local, target_dev=tgt_dev, est=boost2,
                                  with_normals=True, normals=got[1][2]))


def test_factory_zrange_pass_on_the_device():
    """An estimate without a zrange that lands in the z-column gate: the
    factory's ``auto_zrange`` pass runs on the device, with the host
    cloud's result."""
    _, tgt, _ = make_registration_pair(n=50_000, seed=9, kind="uniform",
                                       extent=100.0)
    tgt_local = (tgt - center_offset(tgt)).astype(np.float32)
    tgt_dev = torch.as_tensor(tgt_local)
    (R, tr, ctr, base, zr), _ = estimate_fine_grid_device(tgt_dev, None)
    assert zr is not None and tr >= 2048 and R <= 128
    est = (R, tr, ctr, base, None)
    got = make_pallas_nn_device(None, target_dev=tgt_dev, est=est)
    want = make_pallas_nn_device(tgt_local, target_dev=tgt_dev, est=est)
    _assert_factories_equal(got, want)
    assert _closure(got[0])["trange"] == zr


def test_factory_without_a_host_cloud_needs_the_estimate():
    tgt_dev = torch.as_tensor(
        make_registration_pair(n=5_000, seed=10)[1].astype(np.float32))
    for kw in ({}, {"resolution": 32}, {"trange": 1024}):
        with pytest.raises(ValueError, match="host cloud"):
            make_pallas_nn_device(None, target_dev=tgt_dev, **kw)
    with pytest.raises(ValueError, match="target_local or target_dev"):
        make_pallas_nn_device(None)


@pytest.mark.parametrize("estimator, n", [("point", 4000), ("plane", 7000)])
def test_registration_bit_equal_to_the_numpy_prep(estimator, n, monkeypatch):
    """A multiscale registration at UTM scale (plane: the two-stage fine
    level, which 7,000 points reach) gives the same transform and
    histories with the device prep as with the numpy one."""
    src, tgt, _ = make_registration_pair(n=n, seed=21, noise_sigma=0.02,
                                         extent=100.0)
    src, tgt = src + UTM, tgt + UTM
    # 15 coarse iterations leave the fine level no tile to repair: the
    # plain sweeps' repair chain is the slow part on the CPU.
    kw = dict(coarse_max_points=1500, coarse_iterations=15, max_iterations=6,
              tolerance=0.0, nn_backend="pallas", estimator=estimator,
              device="cpu")
    two_stage, real = [], multiscale._prepare_fine

    def spy(*a, **k):
        out = real(*a, **k)
        two_stage.append(out[2] is not None)
        return out

    monkeypatch.setattr(multiscale, "_prepare_fine", spy)
    dev = icp_register_multiscale(src, tgt, **kw)
    assert two_stage == [estimator == "plane"]
    monkeypatch.setattr(multiscale, "_prepare_fine", _numpy_prepare_fine)
    host = icp_register_multiscale(src, tgt, **kw)
    assert len(dev.levels) == len(host.levels) == 2
    for (_, a), (_, b) in zip(dev.levels, host.levels):
        assert a.iterations == b.iterations
        assert a.nn_resolution == b.nn_resolution
        for f in ("transform", "history_transform", "history_rmse",
                  "history_valid", "history_mean_dist"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f


_STANDALONE = [("point", "bruteforce"), ("point", "pallas"),
               ("point", "cellblock"), ("point", "hashgrid"),
               ("plane", "bruteforce"), ("plane", "pallas")]
_FIELDS = ("transform", "history_transform", "history_rmse",
           "history_valid", "history_outliers", "history_mean_dist",
           "history_std_dist", "history_threshold", "source_registered")


def _register_both(src, tgt, monkeypatch, device="cpu", **kw):
    """``icp_register`` with its prep and with the former host prep:
    ((result, prep output), (result, prep output))."""
    runs = []
    for fn in (prepare_level, _parent_prepare_level):
        got = []

        def spy(*a, _fn=fn, _got=got, **k):
            _got.append(_fn(*a, **k))
            return _got[-1]

        monkeypatch.setattr(icp, "prepare_level", spy)
        runs.append((icp_register(src, tgt, device=device, **kw), got[0]))
    return runs


def _assert_same_prep(a, b):
    """The offset, the device clouds and the NN's resolution, bit for
    bit."""
    (sa, ta, oa), nn_a, _, rows_a = a
    (sb, tb, ob), nn_b, _, rows_b = b
    assert np.array_equal(_bits(oa), _bits(ob))
    for x, y in ((sa, sb), (ta, tb)):
        assert x.dtype == y.dtype
        assert np.array_equal(_bits(x.cpu().numpy()), _bits(y.cpu().numpy()))
    assert nn_a[2] == nn_b[2]
    assert (rows_a is None) == (rows_b is None)
    if rows_a is not None:
        assert torch.equal(rows_a, rows_b)


def _assert_same_registration(a, b):
    assert (a.iterations, a.stop_reason, a.nn_resolution) == (
        b.iterations, b.stop_reason, b.nn_resolution)
    for f in _FIELDS:
        assert np.array_equal(getattr(a, f), getattr(b, f),
                              equal_nan=True), f


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("estimator, backend", _STANDALONE)
def test_icp_register_bit_equal_to_the_host_prep(estimator, backend, center,
                                                 dtype, monkeypatch):
    """A standalone registration at UTM scale, pre-aligned by an initial
    transform, gives the former host path's offset, clouds, resolution,
    transform, histories and registered cloud with the device prep.

    The one exception is the grid rule: the sweep keys its box on the
    target in the loop's dtype. Uncentred in f32 the UTM target's values
    lie on a 0.5 m lattice, so its extent, and the cell size with it, is
    not the f64 cloud's (the origin is: rounding is monotone); the grid
    differs and the exact NN's ties fall otherwise."""
    src, tgt, _ = make_registration_pair(n=4000, seed=21, noise_sigma=0.02,
                                         extent=100.0)
    src, tgt = src + UTM, tgt + UTM
    T = np.eye(4)
    T[:3, 3] = [0.05, -0.03, 0.01]
    (dev, a), (host, b) = _register_both(
        src, tgt, monkeypatch, nn_backend=backend, estimator=estimator,
        center=center, dtype=dtype, initial_transform=T, max_iterations=4,
        tolerance=0.0)
    _assert_same_prep(a, b)
    if backend == "pallas" and dtype == torch.float32 and not center:
        ga, gb = a[1][1][0], b[1][1][0]
        assert torch.equal(ga.origin, gb.origin)
        assert not torch.equal(ga.cell_size, gb.cell_size)
        assert (dev.iterations, dev.stop_reason) == (host.iterations,
                                                     host.stop_reason)
    else:
        _assert_same_registration(dev, host)


@pytest.mark.parametrize("backend", ["bruteforce", "pallas", "cellblock",
                                     "hashgrid"])
def test_icp_register_nonfinite_bit_equal_to_the_host_prep(backend,
                                                           monkeypatch):
    """Non-finite source rows (every backend stops with the numerical
    error after the first NN): the device prep's offset, clouds and result
    are the host path's."""
    src, tgt = _utm_pair(20_000, 4)
    src[5, 0], src[6, 1], src[7, 2] = np.nan, np.inf, -np.inf
    (dev, a), (host, b) = _register_both(
        src, tgt, monkeypatch, nn_backend=backend, max_iterations=3,
        tolerance=0.0)
    _assert_same_prep(a, b)
    _assert_same_registration(dev, host)


def test_forced_resolution_takes_the_estimates_coarse_trange(monkeypatch):
    """A forced ``grid_resolution`` (plane mode: the normals are sized by
    it too): the sweep's coarse trange is the estimate's notch, as on the
    multiscale fine level (the former host path took the 16,384 cap). It
    sets only the repair chain's coarse window, so the coarse grid's
    padding is all that differs: the fine grid, the normals and the
    registration are the same bit for bit."""
    src, tgt, _ = make_registration_pair(n=4000, seed=21, noise_sigma=0.02,
                                         extent=100.0)
    src, tgt = src + UTM, tgt + UTM
    (dev, a), (host, b) = _register_both(
        src, tgt, monkeypatch, nn_backend="pallas", estimator="plane",
        grid_resolution=16, max_iterations=4, tolerance=0.0)
    _assert_same_prep(a, b)
    (fa, sa, _), (fb, sb, _) = a[1], b[1]
    est, _ = estimate_fine_grid_device(a[0][1], 16)
    ca, cb = _closure(fa), _closure(fb)
    assert (ca.pop("coarse_trange"), cb.pop("coarse_trange")) == (est[2],
                                                                  16384)
    assert est[2] < 16384 and ca == cb
    for x, y in zip(sa[0], sb[0]):
        assert torch.equal(x, y)
    assert all(torch.equal(x, y) for x, y in zip(sa[1][1:], sb[1][1:]))
    assert sa[1].tgt_t.shape[1] < sb[1].tgt_t.shape[1]
    assert (sa[2] is None) == (sb[2] is None)
    if sa[2] is not None:
        assert torch.equal(sa[2], sb[2])
    _assert_same_registration(dev, host)


def test_spans_host_prep_ms_reads(monkeypatch):
    """Under a collector the multiscale path records every span that
    ``host_prep_ms`` sums, the f64 upload's bytes, no host pass over a
    cloud and the one read of the offset."""
    src, tgt, _ = make_registration_pair(n=6000, seed=12, noise_sigma=0.02)
    src, tgt = src[:5000] + UTM, tgt + UTM
    kw = dict(coarse_max_points=1500, coarse_iterations=3, max_iterations=2,
              tolerance=0.0, nn_backend="pallas", device="cpu")
    with collect(sync=True) as col:
        icp_register_multiscale(src, tgt, **kw)
    s = col.summary()
    for name in ("host_prep", "upload", "grid_est"):
        assert s[name]["calls"] == 1 and s[name]["seconds"] > 0, name
    assert s["upload"]["bytes"] == 24 * (5000 + 6000)
    assert s["host_prep"]["host_passes"] == 0
    assert s["host_prep"]["prep_reads"] == 1


def test_cli_metrics_show_the_prep_counters(tmp_path, monkeypatch):
    """``icp-torch run --multiscale --metrics`` shows ``host_passes`` and
    ``prep_reads`` on ``host_prep``."""
    monkeypatch.setattr(session, "icp_register_multiscale", functools.partial(
        icp_register_multiscale, coarse_max_points=1500,
        coarse_iterations=3))
    sp, tp = tmp_path / "s.las", tmp_path / "t.las"
    assert cli_main(["synth", str(sp), str(tp), "--n", "3000", "--seed",
                     "11", "--noise", "0.02"]) == 0
    assert cli_main(["--device", "cpu", "run", str(sp), str(tp), "-o",
                     str(tmp_path / "r.las"), "--multiscale",
                     "--nn-backend", "pallas", "--max-iterations", "2",
                     "--metrics", str(tmp_path / "m.jsonl")]) == 0
    last = json.loads((tmp_path / "m.jsonl").read_text().splitlines()[-1])
    prep = last["stages"]["host_prep"]
    assert (prep["calls"], prep["host_passes"], prep["prep_reads"]) == (
        1, 0, 1)


# -- on the card ---------------------------------------------------------
# These import no JAX, so on a machine with a card:
#     python -m pytest --noconftest -m cuda tests/test_torch_prep_device.py


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _span_syncs(fn):
    """Run ``fn`` under ``set_sync_debug_mode("warn")``; returns the name
    of the innermost open span at each synchronisation."""
    import warnings

    from iterativeclosestpoint_tpu_torch.runtime import timing

    at = []

    def show(msg, *_a, **_k):
        if "synchroniz" in str(msg):
            sp = timing._open.get()
            at.append(sp[2] if sp is not None else None)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        old, warnings.showwarning = warnings.showwarning, show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            warnings.showwarning = old
    return at


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1_000_000, 10_000_000])
def test_card_prep_bit_equal_with_one_read(card, n, monkeypatch):
    """The card's subtract and round give numpy's bits at the benchmark's
    sizes, ties and non-finite rows included; ``host_prep`` synchronises
    once, for the offset."""
    src, tgt = _utm_pair(n, 11)
    off = center_offset(tgt)
    a = np.float32(37.5) + np.arange(1000, dtype=np.float32)
    mid = (a.astype(np.float64) + np.nextafter(
        a, np.float32(np.inf)).astype(np.float64)) / 2
    src[:1000] = off + mid[:, None]
    src[1000, 0], src[1001, 1], src[1002, 2] = np.nan, np.inf, -np.inf
    _assert_prep_bit_equal(src, tgt, monkeypatch, dev=card)
    with collect(sync=False):
        at = _span_syncs(lambda: prepare_level(
            src, tgt, card, nn_backend="pallas"))
    assert at.count("host_prep") == 1, at


@pytest.mark.cuda
@pytest.mark.parametrize("kind, n, estimator", [
    ("terrain", 1_000_000, "point"), ("uniform", 1_000_000, "point"),
    ("terrain", 10_000_000, "plane")])
def test_card_registration_bit_equal_to_the_numpy_prep(card, kind, n,
                                                       estimator,
                                                       monkeypatch):
    """The benchmark's shapes on the card: the device prep and the numpy
    one give the same transform and histories (plane at 10M: the two-stage
    fine level)."""
    src, tgt, _ = make_registration_pair(n=n, seed=13, noise_sigma=0.02,
                                         kind=kind, extent=100.0)
    src, tgt = src + UTM, tgt + UTM
    kw = dict(max_iterations=6, tolerance=0.0, nn_backend="pallas",
              estimator=estimator, device=card)
    dev = icp_register_multiscale(src, tgt, **kw)
    monkeypatch.setattr(multiscale, "_prepare_fine", _numpy_prepare_fine)
    host = icp_register_multiscale(src, tgt, **kw)
    assert len(dev.levels) == len(host.levels)
    for (_, a), (_, b) in zip(dev.levels, host.levels):
        assert a.iterations == b.iterations
        for f in ("transform", "history_transform", "history_rmse",
                  "history_valid", "history_mean_dist"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("n, backend", [(29_412, "bruteforce"),
                                        (555_556, "pallas")])
def test_card_icp_register_bit_equal_to_the_host_prep(card, n, backend,
                                                      monkeypatch):
    """The coarse levels' shapes on the card (the 1M cells' brute-force
    level, the 10M cell's slab-sweep middle level): ``icp_register`` with
    the device prep gives the former host path's offset, clouds, grid and
    registration bit for bit."""
    src, tgt, _ = make_registration_pair(n=n, seed=13, noise_sigma=0.02,
                                         kind="terrain", extent=100.0)
    src, tgt = src + UTM, tgt + UTM
    T = np.eye(4)
    T[:3, 3] = [0.05, -0.03, 0.01]
    (dev, a), (host, b) = _register_both(
        src, tgt, monkeypatch, device=card, nn_backend=backend,
        initial_transform=T, max_iterations=6, tolerance=0.0)
    _assert_same_prep(a, b)
    if backend == "pallas":
        _assert_factories_equal(a[1], b[1])
    _assert_same_registration(dev, host)
