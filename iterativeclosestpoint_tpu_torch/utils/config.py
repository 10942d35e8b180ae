"""Typed configuration with validation + JSON persistence.

Equivalent of the reference's ``ICPParameters`` defaults
(``PointCloudRegistration/core/icpengine.h:13-19``) and ``AppSettings`` /
``SettingsService`` persistence (``services/settingsservice.h:12-28``,
``settingsservice.cpp:15-67``). Validation ranges mirror the settings-page
editors (``ui/pages/settingspage.cpp:52-78``).

The port's own copy of the JAX package's ``utils/config.py``: the same
fields, ranges, JSON and default path, so one settings file serves both
packages.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any


@dataclasses.dataclass
class ICPConfig:
    """ICP algorithm parameters (reference defaults, icpengine.h:13-19)."""

    max_iterations: int = 50
    tolerance: float = 1e-6
    sigma_multiplier: float = 3.0
    # NN-structure tunables. ``cell_capacity`` is the reference's octree
    # leaf capacity (icpengine.h:17) and applies to the *hashgrid* backend
    # only (its per-cell candidate slots). ``grid_resolution`` = 0 (the
    # default) means data-adaptive sizing (ops.cellblock
    # .auto_resolution_data — the production behavior); a value in
    # [8, 512] forces that many cells per axis on every grid backend.
    cell_capacity: int = 10
    grid_resolution: int = 0
    # "gui" reproduces the first-iteration threshold widening
    # max(3σ, 0.5·mean) slack (icpengine.cpp:249-255); "cli" uses plain
    # mean+3σ from iteration 1 (icp_registration.cpp:523).
    mode: str = "gui"
    # NN backend: "auto" | "bruteforce" | "hashgrid" | "pallas".
    nn_backend: str = "auto"
    # Pose estimator: "point" (reference Kabsch semantics) or "plane"
    # (point-to-plane extension — far faster convergence on smooth scans).
    estimator: str = "point"
    # M-estimator pose-update weighting (extension): "none" | "huber" |
    # "tukey". Statistics/convergence stay on the reference's 3-sigma mask.
    robust: str = "none"

    # Validation ranges from settingspage.cpp:52-78.
    _RANGES = {
        "max_iterations": (1, 1000),
        "tolerance": (1e-10, 1e-2),
        "sigma_multiplier": (1.0, 5.0),
        "cell_capacity": (5, 100),
        "grid_resolution": (8, 512),
    }

    def validate(self) -> "ICPConfig":
        for field, (lo, hi) in self._RANGES.items():
            v = getattr(self, field)
            if field == "grid_resolution" and v == 0:
                continue  # 0 = data-adaptive auto sizing
            if not (lo <= v <= hi):
                raise ValueError(f"{field}={v} outside valid range [{lo}, {hi}]")
        if self.mode not in ("gui", "cli"):
            raise ValueError(f"mode must be 'gui' or 'cli', got {self.mode!r}")
        if self.nn_backend not in (
            "auto", "bruteforce", "hashgrid", "cellblock", "pallas"
        ):
            raise ValueError(f"unknown nn_backend {self.nn_backend!r}")
        if self.estimator not in ("point", "plane"):
            raise ValueError(f"unknown estimator {self.estimator!r}")
        if self.robust not in ("none", "huber", "tukey"):
            raise ValueError(f"unknown robust mode {self.robust!r}")
        return self


@dataclasses.dataclass
class AppSettings:
    """Application-level settings (settingsservice.h:12-28 analog)."""

    icp: ICPConfig = dataclasses.field(default_factory=ICPConfig)
    point_size: float = 2.0
    show_grid: bool = True
    show_axes: bool = True
    restore_last_session: bool = False
    metrics_jsonl: str = ""  # path for per-iteration metric records

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["icp"] = {
            k: v for k, v in d["icp"].items() if not k.startswith("_")
        }
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "AppSettings":
        icp = ICPConfig(**d.pop("icp", {}))
        known = {f.name for f in dataclasses.fields(cls)} - {"icp"}
        return cls(icp=icp, **{k: v for k, v in d.items() if k in known})

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.to_dict(), indent=2))

    @classmethod
    def load(cls, path: str | Path) -> "AppSettings":
        p = Path(path)
        if not p.exists():
            return cls()
        return cls.from_dict(json.loads(p.read_text()))


def default_settings_path() -> Path:
    """Platform config location (QSettings analog)."""
    return Path.home() / ".config" / "iterativeclosestpoint_tpu" / "settings.json"
