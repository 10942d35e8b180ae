"""The library entry reads what it read before it moved from ``run.py``
into ``entries/library.py``.

On the tiny cells of both configurations at two seeds, the entry's pool,
one call on each input, its work and completeness rules and its
``compare`` give the constants below: a digest of the bytes of every
record's ``T`` and ``hist`` arrays (every level), each record's work and
whether it completed, and ``compare``'s readings over the records. The
constants were computed on the parent commit, before the move, with
``run.py``'s ``library_entry``, ``synth.make_pool``, ``run_cell``'s
inline work and failure rules and ``check.compare``, on the CPU with
torch 2.13.0+cpu, numpy 2.0.2 and scipy 1.17.0 at two torch threads
(one thread rounds differently).
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from portbench.run import entry_module, load_cell

PINNED = {
    ("terrain1m-point.tiles-near", 5): (
        [("04fa521825ff21212178f752", 24000, True),
         ("f76c53f360156d6ef1f5d9dd", 24000, True)],
        {"pose_m": 0.00010557225660990953, "mean_rel": 3.733205466715282e-06,
         "rmse_rel": 2.5908702226959543e-06, "valid_share": 0.0,
         "stop_gap": 0.0}),
    ("terrain1m-point.tiles-near", 2**32 + 7): (
        [("5181094d49c3073fea4bc8a7", 24000, True),
         ("ada2c0123c2cfc739bfd7416", 24000, True)],
        {"pose_m": 7.788371154108407e-05, "mean_rel": 4.0504785048704114e-06,
         "rmse_rel": 5.203102469316114e-06, "valid_share": 0.0,
         "stop_gap": 0.0}),
    ("terrain10m-plane.tiles-near", 5): (
        [("a96a266095750c43dd774bcd", 24000, True),
         ("1eb089a30764e421d13e6cb0", 24000, True)],
        {"pose_m": 6.067929684284575e-05, "mean_rel": 7.471762637849148e-06,
         "rmse_rel": 7.127688284181219e-06, "valid_share": 0.0,
         "stop_gap": 0.0}),
    ("terrain10m-plane.tiles-near", 2**32 + 7): (
        [("0f027f5a8df2476bfa9461c7", 24000, True),
         ("b1f5b5552b60ed6bd9b2d76e", 24000, True)],
        {"pose_m": 0.000328511609626781, "mean_rel": 1.0464247843578836e-05,
         "rmse_rel": 0.0002913077015822028,
         "valid_share": 0.00016666666666666666, "stop_gap": 0.0}),
}


def digest(levels) -> str:
    """The first 24 hex digits of the SHA-256 of every level's ``T`` and
    ``hist`` arrays, each with its dtype and shape."""
    h = hashlib.sha256()
    for lv in levels:
        for a in (lv["T"], lv["hist"]["T"], lv["hist"]["rmse"],
                  lv["hist"]["mean"], lv["hist"]["valid"]):
            a = np.ascontiguousarray(a)
            h.update(f"{a.dtype.str}{a.shape}".encode())
            h.update(a.tobytes())
    return h.hexdigest()[:24]


@pytest.mark.parametrize("cell, seed", list(PINNED))
def test_the_library_entry_reads_as_before_the_move(tiny_root, cell, seed):
    torch.set_num_threads(2)  # the constants' thread count
    spec = load_cell(tiny_root, cell)
    settings, traffic = spec["settings"], spec["traffic"]
    entry = entry_module(tiny_root, traffic["entry"])
    call = entry.entry(settings, "cpu")
    pool = entry.pool(settings, seed, traffic)
    regs = [{"index": i, "pair": i, "levels": call(item)}
            for i, item in enumerate(pool)]
    records = [(digest(r["levels"]), entry.work(settings, r["levels"]),
                entry.complete(settings, r["levels"])) for r in regs]
    readings = entry.compare(pool, regs, settings, traffic["check"], seed)
    assert (records, readings) == PINNED[cell, seed]
    assert tuple(readings) == entry.NUMBERS
