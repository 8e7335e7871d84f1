"""Brute-force all-triangles intersector (correctness baseline + tiny scenes).

Replaces optixTrace against a GAS for scenes small enough that testing every
triangle beats building a BVH (the reference's testGeometry()-class scenes,
SURVEY.md §7 M1). Rays are batched [R,3]; triangles are scanned in fixed
chunks with a `lax.scan` carry of the best hit so peak memory is
O(R * CHUNK), never O(R * T). Also the ground-truth oracle the LBVH
traversal kernel is validated against (SURVEY.md §7 M4 test plan).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from henjou.math.constants import TMAX_RAY
from henjou.math.vec import cross, dot

TRI_CHUNK = 256
_DET_EPS = 1e-12


def _pad_tris(tri_verts: jnp.ndarray, chunk: int):
    t = tri_verts.shape[0]
    pad = (-t) % chunk
    if pad:
        # degenerate (zero-area) triangles never intersect
        tri_verts = jnp.concatenate(
            [tri_verts, jnp.zeros((pad, 3, 3), tri_verts.dtype)], axis=0
        )
    return tri_verts, t + pad


def _mt_chunk(ray_o, ray_d, v0, v1, v2, tmin, tmax):
    """Möller–Trumbore for a [R,1,3] ray batch against a [1,C,3] tri chunk.
    Returns (t, u, v, valid) each [R,C]. No backface culling (glass needs
    interior hits, reference BSDFs.h:328-479)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = cross(ray_d, e2)
    det = dot(e1, pvec)
    inv_det = jnp.where(jnp.abs(det) > _DET_EPS, 1.0 / det, 0.0)
    tvec = ray_o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(ray_d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    valid = (
        (jnp.abs(det) > _DET_EPS)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > tmin)
        & (t < tmax)
    )
    return t, u, v, valid


def intersect_bruteforce(tri_verts, ray_o, ray_d, tmin, tmax=TMAX_RAY):
    """Closest-hit query. Returns (hit_t[R], prim_id[R] i32, u[R], v[R],
    is_hit[R]); prim_id == -1 on miss.

    tmin/tmax may be scalars or [R] arrays (shadow rays pass per-lane tmax,
    rt.h:236-242)."""
    tri_verts = jnp.asarray(tri_verts)
    padded, total = _pad_tris(tri_verts, TRI_CHUNK)
    nchunks = total // TRI_CHUNK
    chunks = padded.reshape(nchunks, TRI_CHUNK, 3, 3)

    r = ray_o.shape[0]
    tmin = jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), (r,))
    tmax = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (r,))

    ro = ray_o[:, None, :]
    rd = ray_d[:, None, :]

    def body(carry, chunk_data):
        best_t, best_i, best_u, best_v = carry
        chunk_tris, base = chunk_data
        v0 = chunk_tris[None, :, 0, :]
        v1 = chunk_tris[None, :, 1, :]
        v2 = chunk_tris[None, :, 2, :]
        t, u, v, valid = _mt_chunk(ro, rd, v0, v1, v2, tmin[:, None], tmax[:, None])
        t = jnp.where(valid, t, jnp.inf)
        arg = jnp.argmin(t, axis=1)
        cand_t = jnp.take_along_axis(t, arg[:, None], axis=1)[:, 0]
        cand_u = jnp.take_along_axis(u, arg[:, None], axis=1)[:, 0]
        cand_v = jnp.take_along_axis(v, arg[:, None], axis=1)[:, 0]
        closer = cand_t < best_t
        best_u = jnp.where(closer, cand_u, best_u)
        best_v = jnp.where(closer, cand_v, best_v)
        best_i = jnp.where(closer, base + arg.astype(jnp.int32), best_i)
        best_t = jnp.where(closer, cand_t, best_t)
        return (best_t, best_i, best_u, best_v), None

    # ray-derived init keeps scan-carry varying types consistent under
    # shard_map (see accel/traverse.py note)
    vary_f = (ray_o[:, 0] + ray_d[:, 0] + tmin + tmax) * 0.0
    init = (
        jnp.inf + vary_f,
        jnp.full((r,), -1, jnp.int32) + vary_f.astype(jnp.int32),
        vary_f,
        vary_f,
    )
    bases = jnp.arange(nchunks, dtype=jnp.int32) * TRI_CHUNK
    (best_t, best_i, best_u, best_v), _ = jax.lax.scan(body, init, (chunks, bases))
    is_hit = best_i >= 0
    return best_t, best_i, best_u, best_v, is_hit


def occluded_bruteforce(tri_verts, ray_o, ray_d, tmin, tmax):
    """Any-hit query for shadow rays (TraceOcculution analogue, rt.h:15-41).
    Returns bool [R]."""
    tri_verts = jnp.asarray(tri_verts)
    padded, total = _pad_tris(tri_verts, TRI_CHUNK)
    nchunks = total // TRI_CHUNK
    chunks = padded.reshape(nchunks, TRI_CHUNK, 3, 3)

    r = ray_o.shape[0]
    tmin = jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), (r,))
    tmax = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (r,))
    ro = ray_o[:, None, :]
    rd = ray_d[:, None, :]

    def body(blocked, chunk_tris):
        v0 = chunk_tris[None, :, 0, :]
        v1 = chunk_tris[None, :, 1, :]
        v2 = chunk_tris[None, :, 2, :]
        _, _, _, valid = _mt_chunk(ro, rd, v0, v1, v2, tmin[:, None], tmax[:, None])
        return blocked | jnp.any(valid, axis=1), None

    vary_b = (ray_o[:, 0] + ray_d[:, 0] + tmin + tmax) != (
        ray_o[:, 0] + ray_d[:, 0] + tmin + tmax
    )  # all-False, ray-derived (see shard_map carry note above)
    blocked, _ = jax.lax.scan(body, vary_b, chunks)
    return blocked
