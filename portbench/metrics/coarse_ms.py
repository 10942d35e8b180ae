"""Coarse levels per registration (``models/icp.py`` under the scopes
``coarse``, ``coarse1``, ...), from the synced scopes."""

import re


def read(ctx):
    levels = [v for k, v in ctx["stages"].items()
              if re.fullmatch(r"coarse\d*", k)]
    if not ctx["synced"] or not levels:
        return None
    return sum(levels) / ctx["synced"] * 1e3
