"""Pinhole camera and primary-ray generation (port of
henjou_tpu/runtime/camera.py).

d = normalize(u*right + v*up + f*dir) over the pixel grid with a
per-sample CMJ jitter; right = cross(dir, +Y), up = cross(right, dir),
f = 2/tan(fov), as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from plainref.math.vec import normalize
from plainref.sampling.cmj import CMJState, cmj_2d


class Camera(NamedTuple):
    position: torch.Tensor  # [3]
    direction: torch.Tensor  # [3]
    up: torch.Tensor  # [3]
    right: torch.Tensor  # [3]
    f: torch.Tensor  # 0-d, 2/tan(fov)


def make_camera(position, direction, fov_rad: float, device, up=None,
                right=None) -> Camera:
    position = np.asarray(position, np.float32)
    direction = np.asarray(direction, np.float32)
    direction = direction / np.linalg.norm(direction)
    if right is None or up is None:
        right = np.cross(direction, np.asarray([0.0, 1.0, 0.0], np.float32))
        up = np.cross(right, direction)
    f = 2.0 / np.tan(fov_rad)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return Camera(position=t(position), direction=t(direction), up=t(up),
                  right=t(right), f=t(f))


def camera_rays_centers(cam: Camera, width: int, height: int):
    """Deterministic pixel-centre primary rays for the whole frame (no CMJ
    jitter), the first-hit probes' rays. Returns (origin[W*H,3],
    dir[W*H,3]) in row-major pixel order."""
    pix = torch.arange(width * height, dtype=torch.int64, device=cam.position.device)
    py_i = torch.div(pix, width, rounding_mode="floor")
    px = (pix - py_i * width).to(torch.float32) + 0.5
    py = py_i.to(torch.float32) + 0.5
    u = (2.0 * px - width) / height
    v = (height - 2.0 * py) / height
    d = normalize(
        u[:, None] * cam.right[None, :]
        + v[:, None] * cam.up[None, :]
        + cam.f * cam.direction[None, :]
    )
    o = cam.position[None, :].expand(d.shape)
    return o, d


def project_to_pixel(cam: Camera, pts, width: int, height: int):
    """Inverse of the raygen mapping: world points [N,3] -> continuous
    pixel coordinates (px[N], py[N], valid[N]).

    The reference basis is not orthogonal in general (the contest camera
    keeps world up as the film vertical while the direction pitches,
    dot(up, dir) = -0.27), so this solves the general 3x3 system
    w = P - pos = a*right + b*up + c*dir with the reciprocal basis (triple
    products); a = s*u, b = s*v, c = s*f. valid = the point lies in front
    of the camera (c > 0)."""
    w = pts - cam.position[None, :]
    r, up, dd = cam.right, cam.up, cam.direction
    det = torch.dot(r, torch.linalg.cross(up, dd))
    det = torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    a = (w @ torch.linalg.cross(up, dd)) / det
    b = (w @ torch.linalg.cross(dd, r)) / det
    c = (w @ torch.linalg.cross(r, up)) / det
    valid = c > 1e-6
    denom = torch.where(valid, c, 1.0)
    u = cam.f * a / denom
    v = cam.f * b / denom
    px = (u * height + width) * 0.5
    py = (height - v * height) * 0.5
    return px, py, valid


def camera_rays(cam: Camera, width: int, height: int, pixel_idx, state: CMJState):
    """Primary rays for pixel indices [R] (int64) with one CMJ 2D jitter
    drawn from the per-lane state. Returns (origin[R,3], dir[R,3], state)."""
    xi, state = cmj_2d(state)
    py_i = torch.div(pixel_idx, width, rounding_mode="floor")
    px_i = pixel_idx - py_i * width
    px = px_i.to(torch.float32) + xi[..., 0]
    py = py_i.to(torch.float32) + xi[..., 1]
    # NDC with x scaled by aspect, y flipped so +up is the image top
    u = (2.0 * px - width) / height
    v = (height - 2.0 * py) / height
    d = normalize(
        u[:, None] * cam.right[None, :]
        + v[:, None] * cam.up[None, :]
        + cam.f * cam.direction[None, :]
    )
    o = cam.position[None, :].expand(d.shape)
    return o, d, state
