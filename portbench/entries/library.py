"""The entry ``library``: one registration of a tile pair through
``icp_register_multiscale`` on the pair's host float64 arrays.

The pool is ``synth.make_pool``'s distinct pairs; the record of a call is
its levels (``level_record``); a call's work is its source points times
its fine iterations; a call that stops short of ``max_iterations`` fine
iterations or returns a non-finite pose has failed; ``check.compare``
decides ``correct``.
"""

from __future__ import annotations

import numpy as np

from portbench import check as icp_check
from portbench import synth

NUMBERS = icp_check.NUMBERS


def library_entry(settings: dict, device):
    """One registration through ``icp_register_multiscale`` on the
    pair's host float64 arrays; returns its record (``check.py``)."""
    import torch

    from iterativeclosestpoint_tpu_torch.models.multiscale import (
        icp_register_multiscale,
    )

    kwargs = dict(
        coarse_max_points=settings["coarse_max_points"],
        coarse_iterations=settings["coarse_iterations"],
        coarse_tolerance=settings["coarse_tolerance"],
        max_iterations=settings["max_iterations"],
        tolerance=settings["tolerance"],
        sigma_multiplier=settings["sigma_multiplier"],
        mode=settings["mode"],
        estimator=settings["estimator"],
        nn_backend=settings["nn_backend"],
        dtype=getattr(torch, settings["dtype"]),
        return_registered=settings["return_registered"],
        device=device,
    )

    def register(pair):
        res = icp_register_multiscale(pair["source"], pair["target"],
                                      **kwargs)
        return [level_record(s, r) for s, r in res.levels]

    return register


def level_record(stride: int, res) -> dict:
    """What the check reads of one level's result, as host copies."""
    return {
        "stride": int(stride),
        "iterations": int(res.iterations),
        "stop": int(res.stop_reason),
        "T": np.array(res.transform, np.float64),
        "hist": {
            "T": np.array(res.history_transform, np.float64),
            "rmse": np.array(res.history_rmse),
            "mean": np.array(res.history_mean_dist),
            "valid": np.array(res.history_valid),
        },
    }


entry = library_entry


def pool(settings: dict, seed: int, traffic: dict) -> list:
    return synth.make_pool(settings["n_points"], seed, traffic)


def points(settings: dict) -> int:
    return settings["n_points"]


def iterations(settings: dict, levels: list) -> int:
    return levels[-1]["iterations"]


def work(settings: dict, levels: list) -> float:
    return settings["n_points"] * levels[-1]["iterations"]


def complete(settings: dict, levels: list) -> bool:
    return (levels[-1]["iterations"] == settings["max_iterations"]
            and bool(np.isfinite(levels[-1]["T"]).all()))


def compare(pool: list, done: list, settings: dict, check: dict, seed: int,
            log=None) -> dict:
    return icp_check.compare(pool, done, settings, check, seed, log=log)
