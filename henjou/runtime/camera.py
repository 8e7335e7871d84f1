"""Pinhole camera + primary-ray generation.

The reference's raygen is reconstructed (SURVEY.md §0): the host uploads
camera pos/dir/up/right and f = 2/tan(fov) (renderer.h:1149-1233); raygen
builds d = normalize(u*right + v*up + f*dir) over the pixel grid with a
per-sample CMJ jitter. The basis convention (right = cross(dir, +Y),
up = cross(right, dir), renderer.h:1165-1168) is kept exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from henjou.math.vec import cross, normalize
from henjou.sampling.cmj import CMJState, cmj_2d


class Camera(NamedTuple):
    position: jnp.ndarray  # [3]
    direction: jnp.ndarray  # [3]
    up: jnp.ndarray  # [3]
    right: jnp.ndarray  # [3]
    f: jnp.ndarray  # scalar, 2/tan(fov)


def make_camera(position, direction, fov_rad: float, up=None, right=None) -> Camera:
    position = np.asarray(position, np.float32)
    direction = np.asarray(direction, np.float32)
    direction = direction / np.linalg.norm(direction)
    if right is None or up is None:
        # reference: renderer.h:1165-1168 (static camera branch)
        right = np.cross(direction, np.asarray([0.0, 1.0, 0.0], np.float32))
        up = np.cross(right, direction)
    f = 2.0 / np.tan(fov_rad)  # reference: renderer.h:1152
    return Camera(
        position=jnp.asarray(position),
        direction=jnp.asarray(direction),
        up=jnp.asarray(up, jnp.float32),
        right=jnp.asarray(right, jnp.float32),
        f=jnp.asarray(f, jnp.float32),
    )


def divmod_u24(i: jnp.ndarray, n: int):
    """Exact (i // n, i % n) for u32 values below 2^24 WITHOUT integer
    division: `%`/`//` by a non-power-of-two expands to a long instruction
    sequence. Float estimate + one correction step is exact in this range
    (pixel counts < 16.7M) and costs a handful of elementwise ops."""
    i_f = i.astype(jnp.float32)
    q = jnp.floor(i_f * np.float32(1.0 / n)).astype(jnp.int32)
    r = i.astype(jnp.int32) - q * n
    over = r >= n
    under = r < 0
    q = q + over.astype(jnp.int32) - under.astype(jnp.int32)
    r = r - jnp.where(over, n, 0) + jnp.where(under, n, 0)
    return q.astype(i.dtype), r.astype(i.dtype)


def camera_rays_centers(cam: Camera, width: int, height: int):
    """Deterministic pixel-CENTER primary rays for the whole frame (no CMJ
    jitter): the depth/position probe used by temporal reprojection.
    Returns (origin[W*H,3], dir[W*H,3]) in row-major pixel order."""
    pix = jnp.arange(width * height, dtype=jnp.uint32)
    py_i, px_i = divmod_u24(pix, width)
    px = px_i.astype(jnp.float32) + 0.5
    py = py_i.astype(jnp.float32) + 0.5
    u = (2.0 * px - width) / height
    v = (height - 2.0 * py) / height
    d = normalize(
        u[:, None] * cam.right[None, :]
        + v[:, None] * cam.up[None, :]
        + cam.f * cam.direction[None, :]
    )
    o = jnp.broadcast_to(cam.position[None, :], d.shape)
    return o, d


def project_to_pixel(cam: Camera, pts: jnp.ndarray, width: int, height: int):
    """Inverse of the raygen mapping: world points [N,3] -> continuous
    pixel coordinates (px[N], py[N], valid[N]).

    right/up follow the reference basis (renderer.h:1165-1168), which is
    NOT orthogonal in general: the contest camera keeps world up=(0,1,0)
    as the film vertical while the direction pitches (dot(up,dir) =
    -0.27), so an orthogonal dual-basis solve is systematically wrong —
    measured ~200 px of vertical reprojection error at 720p, which
    silently zeroed the temporal history gate (BASELINE.md round-5
    temporal ledger). Solve the general 3x3 system instead with the
    reciprocal basis: w = P - pos = a*right + b*up + c*dir with
    a = s*u, b = s*v, c = s*f, via triple products. Exact for any
    non-degenerate basis; valid = point in front of the camera
    (s > 0 <=> c > 0, f > 0)."""
    w = pts - cam.position[None, :]
    r, up, dd = cam.right, cam.up, cam.direction
    det = jnp.sum(r * jnp.cross(up, dd))
    det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    # multiply+sum, not matmul: a float32 dot may run as TF32 on a GPU
    a = jnp.sum(w * jnp.cross(up, dd), axis=-1) / det
    b = jnp.sum(w * jnp.cross(dd, r), axis=-1) / det
    c = jnp.sum(w * jnp.cross(r, up), axis=-1) / det
    valid = c > 1e-6
    denom = jnp.where(valid, c, 1.0)
    u = cam.f * a / denom
    v = cam.f * b / denom
    px = (u * height + width) * 0.5
    py = (height - v * height) * 0.5
    return px, py, valid


def camera_rays(
    cam: Camera,
    width: int,
    height: int,
    pixel_idx: jnp.ndarray,
    state: CMJState,
):
    """Primary rays for pixel indices [R] with one CMJ 2D jitter drawn from
    the per-lane state. Returns (origin[R,3], dir[R,3], state)."""
    xi, state = cmj_2d(state)
    py_i, px_i = divmod_u24(pixel_idx, width)
    px = px_i.astype(jnp.float32) + xi[..., 0]
    py = py_i.astype(jnp.float32) + xi[..., 1]
    # NDC with x scaled by aspect, y flipped so +up is the image top
    u = (2.0 * px - width) / height
    v = (height - 2.0 * py) / height
    d = normalize(
        u[:, None] * cam.right[None, :]
        + v[:, None] * cam.up[None, :]
        + cam.f * cam.direction[None, :]
    )
    o = jnp.broadcast_to(cam.position[None, :], d.shape)
    return o, d, state
