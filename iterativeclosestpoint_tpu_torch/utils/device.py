"""Device choice for the port's entry points.

``device=None`` means the card. A CUDA request on a machine without CUDA
raises; nothing carries on quietly on the CPU. ``device="cpu"`` runs every
kernel's plain PyTorch version (the CPU tests do this).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """Resolve an entry point's ``device`` argument and pin full-f32 matmuls.

    TF32 keeps ~10 mantissa bits; the pose solve and the covariance sums need
    full f32, as the JAX package pins with ``highest_matmul_precision``
    (``models/icp.py:269``).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested (device=None means the card) but "
            "torch.cuda.is_available() is false; pass device='cpu' to run "
            "the plain PyTorch versions"
        )
    return dev
