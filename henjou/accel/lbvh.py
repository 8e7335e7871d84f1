"""LBVH build on device (Karras 2012): Morton codes -> radix sort ->
parallel radix-tree hierarchy -> bottom-up AABBs.

This is the on-device replacement for OptiX GAS builds
(reference buildGAS, renderer.h:319-396). Because the scene is flattened
to world space every frame (scenedata.build_frame_scene), a single-level
LBVH over world triangles also subsumes the reference's per-frame IAS
rebuild (renderer.h:398-490) — rebuild is one jitted call, O(N log N) in
sort work, fully parallel.

Every stage is data-parallel over triangles/nodes:
- Morton: 10 bits/axis quantized centroids, bit-interleaved elementwise.
- Sort: XLA's `jnp.argsort`.
- Hierarchy: each internal node independently finds its key range and
  split by binary search over common-prefix lengths (delta), following
  Karras 2012 exactly; ties broken by index so keys are unique.
- AABB: fixed-depth sweeps unioning children into parents (tree depth is
  bounded by the 62-bit effective key length).

Node layout (SoA): internal nodes are ids [0, T-2], leaves are
[T-1, 2T-2]; leaf id T-1+i holds sorted-triangle i.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

_MORTON_BITS = 10  # per axis -> 30-bit codes


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LBVH:
    left: jnp.ndarray  # [T-1] i32 child node id
    right: jnp.ndarray  # [T-1] i32
    aabb_min: jnp.ndarray  # [2T-1, 3] f32 per node
    aabb_max: jnp.ndarray  # [2T-1, 3]
    tri_order: jnp.ndarray  # [T] i32: leaf i -> original triangle id
    tri_verts: jnp.ndarray  # [T,3,3] f32 in SORTED leaf order
    num_tris: int = dataclasses.field(metadata=dict(static=True))


def _expand_bits(v: jnp.ndarray) -> jnp.ndarray:
    """Spread the low 10 bits of v so there are 2 zeros between each
    (standard Morton interleave)."""
    v = (v * jnp.uint32(0x00010001)) & jnp.uint32(0xFF0000FF)
    v = (v * jnp.uint32(0x00000101)) & jnp.uint32(0x0F00F00F)
    v = (v * jnp.uint32(0x00000011)) & jnp.uint32(0xC30C30C3)
    v = (v * jnp.uint32(0x00000005)) & jnp.uint32(0x49249249)
    return v


def morton_codes(centroids: jnp.ndarray, lo: jnp.ndarray, hi: jnp.ndarray):
    """30-bit Morton codes for [T,3] points within AABB (lo, hi)."""
    extent = jnp.maximum(hi - lo, 1e-12)
    q = jnp.clip((centroids - lo) / extent, 0.0, 1.0 - 1e-7)
    scaled = (q * (1 << _MORTON_BITS)).astype(jnp.uint32)
    scaled = jnp.minimum(scaled, jnp.uint32((1 << _MORTON_BITS) - 1))
    x = _expand_bits(scaled[:, 0])
    y = _expand_bits(scaled[:, 1])
    z = _expand_bits(scaled[:, 2])
    return (x << 2) | (y << 1) | z


def _clz32(x: jnp.ndarray) -> jnp.ndarray:
    return jax.lax.clz(x.astype(jnp.uint32)).astype(jnp.int32)


def _delta_fn(codes: jnp.ndarray, t: int):
    """delta(i, j): common-prefix length of keys i and j; -1 out of range.
    Equal Morton codes fall back to index bits (Karras §4 tie-break)."""

    def delta(i, j):
        oob = (j < 0) | (j >= t)
        j_safe = jnp.clip(j, 0, t - 1)
        ci = codes[i]
        cj = codes[j_safe]
        same = ci == cj
        d_code = _clz32(ci ^ cj)
        d_idx = 32 + _clz32(i.astype(jnp.uint32) ^ j_safe.astype(jnp.uint32))
        return jnp.where(oob, -1, jnp.where(same, d_idx, d_code))

    return delta


def _build_radix_tree(codes: jnp.ndarray, t: int):
    """Karras 2012 parallel radix-tree construction. Returns (left, right)
    child ids for the t-1 internal nodes (leaves are t-1+i)."""
    delta = _delta_fn(codes, t)
    i = jnp.arange(t - 1, dtype=jnp.int32)

    d = jnp.sign(delta(i, i + 1) - delta(i, i - 1)).astype(jnp.int32)
    d = jnp.where(d == 0, 1, d)
    delta_min = delta(i, i - d)

    # upper bound on range length (exponential probe)
    def probe_body(_, lmax):
        cont = delta(i, i + lmax * d) > delta_min
        return jnp.where(cont, lmax * 2, lmax)

    # 30 doublings cover t up to 2^30
    lmax = jax.lax.fori_loop(
        0, 30, probe_body, jnp.full((t - 1,), 2, jnp.int32)
    )

    # binary search the exact other end j (largest l with
    # delta(i, i+l*d) > delta_min)
    def search_body(ref_delta):
        def body(_, carry):
            acc, step = carry
            step = (step + 1) // 2
            cand = acc + step
            ok = delta(i, i + cand * d) > ref_delta
            return (jnp.where(ok, cand, acc), step)

        return body

    l, _ = jax.lax.fori_loop(
        0, 31, search_body(delta_min), (jnp.zeros((t - 1,), jnp.int32), lmax)
    )
    j = i + l * d

    # split position: largest s with delta(i, i+s*d) > delta_node
    delta_node = delta(i, j)
    s, _ = jax.lax.fori_loop(
        0, 31, search_body(delta_node), (jnp.zeros((t - 1,), jnp.int32), l)
    )
    gamma = i + s * d + jnp.minimum(d, 0)

    left_is_leaf = jnp.minimum(i, j) == gamma
    right_is_leaf = jnp.maximum(i, j) == gamma + 1
    leaf_base = t - 1
    left = jnp.where(left_is_leaf, leaf_base + gamma, gamma)
    right = jnp.where(right_is_leaf, leaf_base + gamma + 1, gamma + 1)
    return left.astype(jnp.int32), right.astype(jnp.int32)


def build_lbvh(tri_verts: jnp.ndarray) -> LBVH:
    """Build the LBVH for [T,3,3] world-space triangles. Jittable; T static."""
    t = tri_verts.shape[0]
    if t == 1:
        # degenerate: one leaf, fake internal node pointing at it twice
        mn = jnp.min(tri_verts, axis=1)
        mx = jnp.max(tri_verts, axis=1)
        return LBVH(
            left=jnp.asarray([1], jnp.int32),
            right=jnp.asarray([1], jnp.int32),
            aabb_min=jnp.concatenate([mn, mn], 0),
            aabb_max=jnp.concatenate([mx, mx], 0),
            tri_order=jnp.asarray([0], jnp.int32),
            tri_verts=tri_verts,
            num_tris=1,
        )

    centroids = jnp.mean(tri_verts, axis=1)
    scene_lo = jnp.min(tri_verts.reshape(-1, 3), axis=0)
    scene_hi = jnp.max(tri_verts.reshape(-1, 3), axis=0)
    codes = morton_codes(centroids, scene_lo, scene_hi)

    order = jnp.argsort(codes).astype(jnp.int32)
    codes_sorted = codes[order]
    verts_sorted = tri_verts[order]

    left, right = _build_radix_tree(codes_sorted, t)

    # leaf AABBs
    leaf_min = jnp.min(verts_sorted, axis=1)
    leaf_max = jnp.max(verts_sorted, axis=1)
    num_nodes = 2 * t - 1
    aabb_min = jnp.full((num_nodes, 3), jnp.inf, jnp.float32)
    aabb_max = jnp.full((num_nodes, 3), -jnp.inf, jnp.float32)
    aabb_min = aabb_min.at[t - 1 :].set(leaf_min)
    aabb_max = aabb_max.at[t - 1 :].set(leaf_max)

    # bottom-up union sweeps: depth of a Karras tree over unique keys is
    # bounded by the effective key length (30 code bits + index tie-break);
    # 64 sweeps always converge.
    def sweep(_, mm):
        mn, mx = mm
        new_mn = jnp.minimum(mn[left], mn[right])
        new_mx = jnp.maximum(mx[left], mx[right])
        mn = mn.at[: t - 1].set(new_mn)
        mx = mx.at[: t - 1].set(new_mx)
        return (mn, mx)

    aabb_min, aabb_max = jax.lax.fori_loop(0, 64, sweep, (aabb_min, aabb_max))

    return LBVH(
        left=left,
        right=right,
        aabb_min=aabb_min,
        aabb_max=aabb_max,
        tri_order=order,
        tri_verts=verts_sorted,
        num_tris=t,
    )


def lbvh_depth(bvh: LBVH) -> int:
    """Internal nodes on the longest root-to-leaf path (host-side). A
    traversal stack of `depth + 1` entries never overflows."""
    import numpy as np

    left, right = np.asarray(bvh.left), np.asarray(bvh.right)
    inner = bvh.num_tris - 1
    depth, level = 0, np.asarray([0]) if inner > 0 else np.asarray([], int)
    while level.size:
        depth += 1
        kids = np.concatenate([left[level], right[level]])
        level = kids[kids < inner]
    return depth
