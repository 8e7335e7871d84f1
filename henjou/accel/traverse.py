"""BVH traversal for ray batches (the optixTrace analogue).

Replaces RT-core traversal (reference rt.h:43-69 RayTrace /
rt.h:15-41 TraceOcculution). Vectorized stack traversal: every lane
carries a small node stack; one `lax.while_loop` iteration pops one node
per lane, AABB-tests both children, pushes survivors near-first, and
Möller-Trumbore-tests leaves. Lanes idle (masked) once their stack
empties; the loop exits when all lanes are done — wavefront-coherent
primary rays visit similar node sequences so lockstep loss is modest.

Returns the same contract as accel.bruteforce so the integrators are
oblivious to which intersector runs underneath. This is the CPU route
and the plain reference that the GPU route's CUDA kernel
(accel/cuda_traverse.py) is checked against.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from henjou.accel.lbvh import LBVH
from henjou.math.constants import TMAX_RAY
from henjou.math.vec import cross, dot

STACK_SIZE = 48
_DET_EPS = 1e-12


def _slab_test(bmin, bmax, o, inv_d, tmin, tmax):
    """Ray/AABB slab test. All [R,3] inputs -> (hit[R], tnear[R])."""
    t1 = (bmin - o) * inv_d
    t2 = (bmax - o) * inv_d
    tlo = jnp.minimum(t1, t2)
    thi = jnp.maximum(t1, t2)
    tnear = jnp.maximum(jnp.max(tlo, axis=-1), tmin)
    tfar = jnp.minimum(jnp.min(thi, axis=-1), tmax)
    return tnear <= tfar, tnear


def _mt_single(v0, v1, v2, o, d, tmin, tmax):
    """Möller-Trumbore, one triangle per lane. Returns (t, u, v, valid)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    inv_det = jnp.where(jnp.abs(det) > _DET_EPS, 1.0 / det, 0.0)
    tvec = o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
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


def _inv_dir(ray_d):
    tiny = jnp.where(ray_d >= 0.0, 1e-12, -1e-12)
    return 1.0 / jnp.where(jnp.abs(ray_d) < 1e-12, tiny, ray_d)


def traverse_closest(bvh: LBVH, ray_o, ray_d, tmin, tmax=TMAX_RAY, any_hit=False):
    """Closest-hit traversal. Returns (t[R], prim[R] (ORIGINAL tri ids),
    u[R], v[R], is_hit[R]). With any_hit=True, terminates lanes on the
    first confirmed intersection (shadow-ray mode)."""
    r = ray_o.shape[0]
    t_cnt = bvh.num_tris
    leaf_base = t_cnt - 1
    tmin = jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), (r,))
    tmax = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (r,))
    inv_d = _inv_dir(ray_d)

    # Derive carry inits from the ray inputs (zero-cost): under shard_map
    # the while_loop carry must have the same varying-axis type on input
    # and output, so constants would not typecheck against the body's
    # ray-dependent outputs.
    vary_f = (ray_o[:, 0] + ray_d[:, 0] + tmax) * 0.0
    vary_i = vary_f.astype(jnp.int32)

    stack = jnp.zeros((r, STACK_SIZE), jnp.int32) + vary_i[:, None]
    # push root (node 0); with one triangle the "root" is its leaf
    root = jnp.int32(0 if t_cnt > 1 else 1)
    stack = stack.at[:, 0].set(root)
    sp = jnp.ones((r,), jnp.int32) + vary_i

    best_t = tmax + vary_f
    best_prim = jnp.full((r,), -1, jnp.int32) + vary_i
    best_u = jnp.zeros((r,), jnp.float32) + vary_f
    best_v = jnp.zeros((r,), jnp.float32) + vary_f

    def cond(carry):
        sp = carry[1]
        return jnp.any(sp > 0)

    def body(carry):
        stack, sp, best_t, best_prim, best_u, best_v = carry
        active = sp > 0
        sp_new = jnp.where(active, sp - 1, sp)
        node = stack[jnp.arange(r), jnp.maximum(sp_new, 0)]
        node = jnp.where(active, node, 0)

        is_leaf = node >= leaf_base

        # --- leaf: triangle test ---
        tri_id = jnp.clip(node - leaf_base, 0, t_cnt - 1)
        tri = bvh.tri_verts[tri_id]
        t, u, v, valid = _mt_single(
            tri[:, 0], tri[:, 1], tri[:, 2], ray_o, ray_d, tmin, best_t
        )
        take = active & is_leaf & valid
        best_t = jnp.where(take, t, best_t)
        best_prim = jnp.where(take, bvh.tri_order[tri_id], best_prim)
        best_u = jnp.where(take, u, best_u)
        best_v = jnp.where(take, v, best_v)

        # --- internal: child AABB tests ---
        node_i = jnp.clip(node, 0, leaf_base - 1) if leaf_base > 0 else node * 0
        lchild = bvh.left[node_i]
        rchild = bvh.right[node_i]
        lhit, lnear = _slab_test(
            bvh.aabb_min[lchild], bvh.aabb_max[lchild], ray_o, inv_d, tmin, best_t
        )
        rhit, rnear = _slab_test(
            bvh.aabb_min[rchild], bvh.aabb_max[rchild], ray_o, inv_d, tmin, best_t
        )
        inner = active & ~is_leaf
        lhit = inner & lhit
        rhit = inner & rhit

        # push far child first, near child last (popped first)
        l_is_near = lnear <= rnear
        first = jnp.where(l_is_near, lchild, rchild)  # near
        second = jnp.where(l_is_near, rchild, lchild)  # far
        first_ok = jnp.where(l_is_near, lhit, rhit)
        second_ok = jnp.where(l_is_near, rhit, lhit)

        lanes = jnp.arange(r)
        push1 = second_ok & (sp_new < STACK_SIZE)
        stack = stack.at[lanes, jnp.minimum(sp_new, STACK_SIZE - 1)].set(
            jnp.where(push1, second, stack[lanes, jnp.minimum(sp_new, STACK_SIZE - 1)])
        )
        sp1 = jnp.where(push1, sp_new + 1, sp_new)
        push2 = first_ok & (sp1 < STACK_SIZE)
        stack = stack.at[lanes, jnp.minimum(sp1, STACK_SIZE - 1)].set(
            jnp.where(push2, first, stack[lanes, jnp.minimum(sp1, STACK_SIZE - 1)])
        )
        sp2 = jnp.where(push2, sp1 + 1, sp1)

        if any_hit:
            # shadow mode: a confirmed hit empties the lane's stack
            sp2 = jnp.where(best_prim >= 0, 0, sp2)
        return (stack, sp2, best_t, best_prim, best_u, best_v)

    stack, sp, best_t, best_prim, best_u, best_v = jax.lax.while_loop(
        cond, body, (stack, sp, best_t, best_prim, best_u, best_v)
    )
    is_hit = best_prim >= 0
    t_out = jnp.where(is_hit, best_t, jnp.inf)
    return t_out, best_prim, best_u, best_v, is_hit


def make_bvh_intersector(bvh: LBVH):
    """Adapters matching the accel.bruteforce contract, so closest_hit /
    occluded take these via their intersect_fn / occluded_fn hooks."""

    def intersect_fn(tri_verts, ray_o, ray_d, tmin, tmax=TMAX_RAY):
        # tri_verts ignored: geometry lives (sorted) inside the BVH
        return traverse_closest(bvh, ray_o, ray_d, tmin, tmax)

    def occluded_fn(tri_verts, ray_o, ray_d, tmin, tmax):
        _, prim, _, _, hit = traverse_closest(
            bvh, ray_o, ray_d, tmin, tmax, any_hit=True
        )
        return hit

    return intersect_fn, occluded_fn
