"""The traffic generator: a frozen copy of the port's, pools by seed."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from portbench import synth

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"

MIX = {"kind": "terrain", "extent": 100.0, "noise_sigma": 0.02,
       "utm_offset": [500000.0, 5400000.0, 250.0],
       "tile_step": [200.0, 0.0, 0.0], "pool_points": 12000, "pool_min": 2}


@pytest.mark.parametrize("kind", ["terrain", "uniform", "sphere"])
def test_copy_equals_the_ports_generator(kind):
    from iterativeclosestpoint_tpu_torch.utils import synth as port

    mine = synth.make_registration_pair(3000, seed=9, noise_sigma=0.02,
                                        outlier_frac=0.01, kind=kind,
                                        extent=100.0)
    theirs = port.make_registration_pair(n=3000, seed=9, noise_sigma=0.02,
                                         outlier_frac=0.01, kind=kind,
                                         extent=100.0)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 12345, 2**40 + 3])
def test_same_seed_same_pool(seed):
    a = synth.make_pool(4000, seed, MIX)
    b = synth.make_pool(4000, seed, MIX)
    assert len(a) == 3  # 12,000 points' worth of 4,000-point tiles
    for pa, pb in zip(a, b):
        for key in ("source", "target", "T_true"):
            np.testing.assert_array_equal(pa[key], pb[key])


def test_pool_pairs_are_distinct_and_at_their_offsets():
    pool = synth.make_pool(4000, 5, MIX)
    assert len({p["seed"] for p in pool}) == len(pool)
    for i, p in enumerate(pool):
        centre = (p["target"].min(axis=0) + p["target"].max(axis=0)) / 2
        want = np.array(MIX["utm_offset"]) + i * np.array(MIX["tile_step"])
        assert np.abs(centre[:2] - want[:2]).max() < 1.0
        # T_true maps the source onto the target in the world frame.
        moved = p["source"] @ p["T_true"][:3, :3].T + p["T_true"][:3, 3]
        assert np.abs(moved - p["target"]).max() < 0.2
    for a, b in zip(pool, pool[1:]):
        assert not np.allclose(a["T_true"][:3, :3], b["T_true"][:3, :3])


def test_other_seed_other_pool():
    a = synth.make_pool(4000, 1, MIX)
    b = synth.make_pool(4000, 2, MIX)
    assert not np.array_equal(a[0]["source"], b[0]["source"])


@pytest.mark.parametrize("pool", [2, 3, 4])
def test_schedule_never_repeats_a_pair_back_to_back(pool):
    order = synth.schedule(2**33 + 1, pool, pool)
    assert sorted(order) == list(range(pool))
    seq = [order[i % pool] for i in range(50)]
    assert all(x != y for x, y in zip(seq, seq[1:]))


def test_the_mix_sets_the_motion_envelope():
    mix = dict(MIX, motion={"max_yaw_deg": 1.0, "max_pitch_roll_deg": 0.5,
                            "max_txy": 0.5, "max_tz": 0.2})
    for p in synth.make_pool(2000, 3, mix):
        T = synth.make_registration_pair(10, seed=p["seed"],
                                         motion=mix["motion"])[2]
        assert np.degrees(np.arccos((np.trace(T[:3, :3]) - 1) / 2)) < 1.2
        assert np.abs(T[:2, 3]).max() <= 0.5 and abs(T[2, 3]) <= 0.2


@pytest.mark.parametrize("base", ["tiles", "volume"])
def test_a_near_mix_differs_from_its_reference_envelope_in_motion_alone(base):
    ref = json.loads((TRAFFIC / f"{base}.json").read_text())
    near = json.loads((TRAFFIC / f"{base}-near.json").read_text())
    assert "motion" not in ref  # the reference test generator's envelope
    assert {k for k in ref.keys() | near.keys()
            if ref.get(k) != near.get(k)} == {"motion", "why"}
    default = [synth.random_rigid_transform(seed=s) for s in range(40)]
    assert max(abs(T[0, 3]) for T in default) > near["motion"]["max_txy"]
