"""Device compute: geometry, rigid fit, brute-force NN and the slab-sweep
NN. The exports are the JAX package's ``ops`` names."""

from iterativeclosestpoint_tpu_torch.ops.se3 import (
    apply_transform,
    compose,
    identity_transform,
    rotation_angle_deg,
    se3_from_euler,
    translation_norm,
)
from iterativeclosestpoint_tpu_torch.ops.kabsch import kabsch_masked, kabsch
from iterativeclosestpoint_tpu_torch.ops.bruteforce import nn_bruteforce

__all__ = [
    "apply_transform",
    "compose",
    "identity_transform",
    "rotation_angle_deg",
    "se3_from_euler",
    "translation_norm",
    "kabsch",
    "kabsch_masked",
    "nn_bruteforce",
]
