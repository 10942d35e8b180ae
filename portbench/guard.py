"""The check that nothing of JAX or of the JAX package was loaded."""

from __future__ import annotations

import sys

# Compared with each loaded module's top-level name whole: the port's
# package name begins with the JAX package's.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "iterativeclosestpoint_tpu"})


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default: the
    modules this process has loaded)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
