"""Cluster-scan intersector: an acceleration structure without pointer
chasing.

A classic BVH walk is a chain of per-lane divergent node fetches; this
structure spends dense ray-AABB/ray-triangle math instead (SURVEY.md §7
"hard parts" #1). It is not on any render route (accel/route.py):

- Build: Morton-sort triangles (same codes as the LBVH), group into
  clusters of K=64 contiguous triangles, one AABB per cluster. Clusters
  inherit Morton locality, so they are tight.
- Query: iterate nearest-first over the clusters a ray actually enters:
  every round does ONE dense slab-test scan over all cluster AABBs
  (regular dense work, no gathers) to find each lane's next-nearest
  candidate cluster, then ONE contiguous row-gather of that cluster's
  64 triangles (~2.3 KB/lane — bandwidth-efficient) and a dense 64-wide
  Möller-Trumbore. Lanes stop when no unprocessed cluster is nearer
  than their best hit; typical rays converge in 1-3 rounds.

Exact (no top-M truncation): candidate enumeration is ordered by
(tnear, cluster id), so every cluster that could contain the closest hit
is visited before termination.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from henjou.accel.lbvh import morton_codes
from henjou.math.constants import TMAX_RAY
from henjou.math.vec import cross, dot

CLUSTER_K = 64
_DET_EPS = 1e-12


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ClusterSet:
    aabb_min: jnp.ndarray  # [C,3]
    aabb_max: jnp.ndarray  # [C,3]
    tris: jnp.ndarray  # [C,K,3,3] sorted, padded with degenerates
    tri_order: jnp.ndarray  # [C,K] i32 original tri id (-1 for padding)
    num_clusters: int = dataclasses.field(metadata=dict(static=True))


def build_clusters(tri_verts: jnp.ndarray, k: int = CLUSTER_K) -> ClusterSet:
    """Jittable; T static."""
    t = tri_verts.shape[0]
    centroids = jnp.mean(tri_verts, axis=1)
    lo = jnp.min(tri_verts.reshape(-1, 3), axis=0)
    hi = jnp.max(tri_verts.reshape(-1, 3), axis=0)
    codes = morton_codes(centroids, lo, hi)
    order = jnp.argsort(codes).astype(jnp.int32)

    pad = (-t) % k
    c = (t + pad) // k
    order_p = jnp.concatenate([order, jnp.full((pad,), -1, jnp.int32)])
    verts_sorted = jnp.concatenate(
        [tri_verts[order], jnp.zeros((pad, 3, 3), tri_verts.dtype)], axis=0
    )
    tris = verts_sorted.reshape(c, k, 3, 3)
    tri_order = order_p.reshape(c, k)

    # padded (degenerate) triangles must not pollute cluster AABBs
    valid = (tri_order >= 0)[..., None, None]
    big = jnp.float32(3.4e38)
    vmin = jnp.where(valid, tris, big).reshape(c, k * 3, 3).min(axis=1)
    vmax = jnp.where(valid, tris, -big).reshape(c, k * 3, 3).max(axis=1)
    return ClusterSet(
        aabb_min=vmin, aabb_max=vmax, tris=tris, tri_order=tri_order, num_clusters=c
    )


def _mt64(tris, order, o, d, tmin, tmax):
    """Dense MT: tris [R,K,3,3] vs per-lane rays. Returns closest
    (t, prim, u, v) among valid (order >= 0 masks padding)."""
    v0 = tris[:, :, 0, :]
    e1 = tris[:, :, 1, :] - v0
    e2 = tris[:, :, 2, :] - v0
    ro = o[:, None, :]
    rd = d[:, None, :]
    pvec = cross(rd, e2)
    det = dot(e1, pvec)
    inv_det = jnp.where(jnp.abs(det) > _DET_EPS, 1.0 / det, 0.0)
    tvec = ro - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(rd, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    ok = (
        (jnp.abs(det) > _DET_EPS)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > tmin[:, None])
        & (t < tmax[:, None])
        & (order >= 0)
    )
    t = jnp.where(ok, t, jnp.inf)
    arg = jnp.argmin(t, axis=1)
    lane = jnp.arange(t.shape[0])
    return t[lane, arg], order[lane, arg], u[lane, arg], v[lane, arg]


def _slab_all(cs: ClusterSet, o, inv_d, tmin, tmax):
    """Dense slab test of every lane against every cluster AABB.
    Returns tnear [R,C] (inf where missed)."""
    bmin = cs.aabb_min[None, :, :]  # [1,C,3]
    bmax = cs.aabb_max[None, :, :]
    t1 = (bmin - o[:, None, :]) * inv_d[:, None, :]
    t2 = (bmax - o[:, None, :]) * inv_d[:, None, :]
    tlo = jnp.minimum(t1, t2).max(axis=-1)
    thi = jnp.maximum(t1, t2).min(axis=-1)
    tnear = jnp.maximum(tlo, tmin[:, None])
    ok = tnear <= jnp.minimum(thi, tmax[:, None])
    return jnp.where(ok, tnear, jnp.inf)


def intersect_clusters(
    cs: ClusterSet, ray_o, ray_d, tmin, tmax=TMAX_RAY, any_hit: bool = False,
    max_rounds: int = 64,
):
    """Closest-hit (or any-hit) query. Same contract as
    accel.bruteforce.intersect_bruteforce."""
    r = ray_o.shape[0]
    c = cs.num_clusters
    tmin = jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), (r,))
    tmax = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (r,))
    tiny = jnp.where(ray_d >= 0.0, 1e-12, -1e-12)
    inv_d = 1.0 / jnp.where(jnp.abs(ray_d) < 1e-12, tiny, ray_d)

    # candidate enumeration key: tnear * C + cluster_id, strictly increasing
    cid = jnp.arange(c, dtype=jnp.float32)[None, :]

    vary_f = (ray_o[:, 0] + ray_d[:, 0] + tmin + tmax) * 0.0
    best_t = tmax + vary_f
    best_prim = jnp.full((r,), -1, jnp.int32) + vary_f.astype(jnp.int32)
    best_u = vary_f
    best_v = vary_f
    last_key = vary_f - 1.0  # keys are >= 0
    active = vary_f == 0.0

    rounds0 = jnp.zeros((), jnp.int32)

    def cond(carry):
        return jnp.any(carry[0][0]) & (carry[0][1] < max_rounds + c)

    def body(carry):
        (active, rounds), last_key, best_t, best_prim, best_u, best_v = carry
        tnear = _slab_all(cs, ray_o, inv_d, tmin, jnp.minimum(tmax, best_t))
        # ordered key per cluster; mask out already-processed ones
        key = tnear * c + cid
        key = jnp.where(key > last_key[:, None], key, jnp.inf)
        nxt_key = jnp.min(key, axis=1)
        nxt = jnp.argmin(key, axis=1).astype(jnp.int32)
        has = jnp.isfinite(nxt_key) & active

        tris = cs.tris[nxt]  # [R,K,3,3] contiguous row gather
        order = cs.tri_order[nxt]
        t, prim, u, v = _mt64(tris, order, ray_o, ray_d, tmin, best_t)
        take = has & (t < best_t)
        best_t = jnp.where(take, t, best_t)
        best_prim = jnp.where(take, prim, best_prim)
        best_u = jnp.where(take, u, best_u)
        best_v = jnp.where(take, v, best_v)
        last_key = jnp.where(has, nxt_key, last_key)
        active = has
        if any_hit:
            active = active & (best_prim < 0)
        return ((active, rounds + 1), last_key, best_t, best_prim, best_u, best_v)

    init = ((active, rounds0), last_key, best_t, best_prim, best_u, best_v)
    _, _, best_t, best_prim, best_u, best_v = jax.lax.while_loop(cond, body, init)
    is_hit = best_prim >= 0
    return jnp.where(is_hit, best_t, jnp.inf), best_prim, best_u, best_v, is_hit


def make_cluster_intersector(cs: ClusterSet):
    """Adapters matching the accel.bruteforce contract."""

    def intersect_fn(tri_verts, ray_o, ray_d, tmin, tmax=TMAX_RAY):
        return intersect_clusters(cs, ray_o, ray_d, tmin, tmax)

    def occluded_fn(tri_verts, ray_o, ray_d, tmin, tmax):
        _, _, _, _, hit = intersect_clusters(
            cs, ray_o, ray_d, tmin, tmax, any_hit=True
        )
        return hit

    return intersect_fn, occluded_fn
