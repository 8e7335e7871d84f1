"""Vectorized 3D shading math over [..., 3] arrays.

Vectorized rewrite of the reference's per-thread float3 helpers
(reference: include/kernel/math.h). Every function here is pure, traced
under jit, and batched over arbitrary leading dimensions so a whole
wavefront of rays is processed per call (array ops over the batch instead of
one SIMT thread per ray).

Shading-space convention matches the reference: the surface normal is the
local +Y axis (wo.y == cos(theta)).
"""

from __future__ import annotations

import jax.numpy as jnp

from henjou.math.constants import PI


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product over the last axis; keeps no dims."""
    return jnp.sum(a * b, axis=-1)


def absdot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    # reference: include/kernel/math.h:105-107
    return jnp.abs(dot(a, b))


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1
    )


def norm2(v: jnp.ndarray) -> jnp.ndarray:
    # reference: include/kernel/math.h:88-90
    return dot(v, v)


def length(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(norm2(v))


def normalize(v: jnp.ndarray, eps: float = 1e-20) -> jnp.ndarray:
    return v * jax_rsqrt(jnp.maximum(norm2(v), eps))[..., None]


def jax_rsqrt(x: jnp.ndarray) -> jnp.ndarray:
    return 1.0 / jnp.sqrt(x)


def reflect(v: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """CUDA-helpers convention: reflect(-wo, m) gives the mirrored outgoing
    direction, i.e. r = v - 2*dot(v, n)*n."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(
    v: jnp.ndarray,
    n: jnp.ndarray,
    ior1: jnp.ndarray,
    ior2: jnp.ndarray,
):
    """Snell refraction of incident direction `v` (pointing away from the
    surface) about normal `n`, from medium ior1 into ior2.

    Returns (ok, r): ok=False marks total internal reflection lanes
    (r undefined there). reference: include/kernel/math.h:92-103.
    """
    eta = jnp.asarray(ior1) / jnp.asarray(ior2)
    t_h = -eta[..., None] * (v - dot(v, n)[..., None] * n)
    sin2 = norm2(t_h)
    ok = sin2 <= 1.0
    t_p = -jnp.sqrt(jnp.maximum(1.0 - sin2, 0.0))[..., None] * n
    return ok, t_h + t_p


def lerp(a, b, t):
    return a * (1.0 - t) + b * t


def smoothstep(a, b, t):
    x = jnp.clip((t - a) / (b - a), 0.0, 1.0)
    return x * x * (3.0 - 2.0 * x)


def step(a, x):
    return (a < x).astype(jnp.float32)


def schlick_fresnel(F0: jnp.ndarray, w: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Schlick approximation with an RGB F0. reference: math.h:26-29."""
    term1 = 1.0 - dot(w, n)
    return (1.0 - F0) * (term1**5)[..., None] + F0


def schlick_fresnel_ior(no, ni, w: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Scalar Schlick from a pair of IORs. reference: math.h:31-37."""
    F0 = (no - ni) / (no + ni)
    F0 = F0 * F0
    term1 = 1.0 - dot(w, n)
    return F0 + (1.0 - F0) * term1**5


def orthonormal_basis(n: jnp.ndarray):
    """Branchless ONB (Duff et al. 2017). Returns (tangent, binormal).

    reference: include/kernel/math.h:43-51 — this version replaces the
    copysign branch with arithmetic select so all lanes stay coherent.
    """
    sign = jnp.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    tangent = jnp.stack(
        [
            1.0 + sign * n[..., 0] * n[..., 0] * a,
            sign * b,
            -sign * n[..., 0],
        ],
        axis=-1,
    )
    binormal = jnp.stack(
        [b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], axis=-1
    )
    return tangent, binormal


def world_to_local(v, t, n, b):
    """World direction -> shading-local (t, n, b) with n as +Y.
    reference: math.h:53-59."""
    return jnp.stack([dot(v, t), dot(v, n), dot(v, b)], axis=-1)


def local_to_world(v, t, n, b):
    # reference: math.h:61-71
    return (
        v[..., 0:1] * t + v[..., 1:2] * n + v[..., 2:3] * b
    )


def cosine_sampling(u, v):
    """Cosine-weighted hemisphere sample (local +Y up) and its pdf.

    Matches the reference draw exactly, including the theta construction
    (reference: include/kernel/math.h:7-15): theta = 0.5*acos(1-2u).
    Returns (wi[..., 3], pdf[...]).
    """
    phi = 2.0 * PI * v
    theta = 0.5 * jnp.arccos(jnp.clip(1.0 - 2.0 * u, -1.0, 1.0))
    cos_t = jnp.cos(theta)
    sin_t = jnp.sin(theta)
    wi = jnp.stack([jnp.cos(phi) * sin_t, cos_t, jnp.sin(phi) * sin_t], axis=-1)
    pdf = cos_t / PI
    return wi, pdf


def hemisphere_sampling(u, v):
    """Uniform hemisphere sample. reference: math.h:17-24."""
    phi = 2.0 * PI * v
    cos_t = u
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
    wi = jnp.stack([jnp.cos(phi) * sin_t, cos_t, jnp.sin(phi) * sin_t], axis=-1)
    pdf = jnp.full_like(u, 1.0 / (2.0 * PI))
    return wi, pdf


def polar_to_xyz(theta, phi):
    """Y-up spherical to cartesian. reference: math.h:39-41."""
    st = jnp.sin(theta)
    return jnp.stack([st * jnp.cos(phi), jnp.cos(theta), st * jnp.sin(phi)], axis=-1)


def transform_position(mat: jnp.ndarray, pos: jnp.ndarray) -> jnp.ndarray:
    """Apply a row-major [..., 3, 4] affine to points. reference: math.h:73-76.

    Written as broadcast multiply+sum, NOT einsum/dot: XLA may run a
    float32 dot at reduced precision (TF32 on tensor cores) unless asked
    otherwise — geometry must stay exact f32."""
    return jnp.sum(mat[..., :3, :3] * pos[..., None, :], axis=-1) + mat[..., :3, 3]


def transform_direction(mat: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """Rotate/scale a direction (w=0) by a [..., 3, 4] affine."""
    return jnp.sum(mat[..., :3, :3] * d[..., None, :], axis=-1)


def transform_normal(inv_mat: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Transform a normal by the inverse-transpose: pass the INVERSE affine,
    this applies its 3x3 transpose. reference: math.h:78-87."""
    return jnp.sum(inv_mat[..., :3, :3] * n[..., :, None], axis=-2)
