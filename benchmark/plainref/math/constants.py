"""Math constants (port of henjou_tpu/math/constants.py)."""

import numpy as np

PI = float(np.pi)
PI2 = 2.0 * PI
INV_PI = 1.0 / PI
HALF_PI = 0.5 * PI

# Ray epsilon of the reference integrators (absolute 1e-3 tmin, 1e16
# tmax); the integrators use the scene-relative `ray_eps` below instead.
EPS_RAY = 1e-3
EPS_RAY_REL = 1e-4  # of the scene AABB diagonal
TMAX_RAY = 1e16


def ray_eps(frame):
    """Scene-relative primary-ray tmin: EPS_RAY_REL x the scene AABB
    diagonal (floor 1e-30 for degenerate scenes), as a 0-d f32 tensor."""
    import torch

    v = frame.tri_verts.reshape(-1, 3)
    diag = torch.linalg.vector_norm(v.amax(dim=0) - v.amin(dim=0))
    return torch.clamp(diag * EPS_RAY_REL, min=1e-30)


# Shadow-ray tmax shortening, relative to the light distance.
SHADOW_EPS_REL = 1e-3
