"""Unidirectional path tracer (BSDF sampling only).

Rebuild of the reference `Pathtrace` integrator (include/kernel/rt.h:85-159):
MaxDepth=10 bounce loop, Russian roulette on max throughput, first-bounce
albedo/normal AOV capture, emission on miss or light hit.

Lockstep shape: instead of one SIMT thread recursing per pixel, the whole ray
batch marches in lockstep through a `lax.fori_loop` over depth with an
alive mask (wavefront-style; SURVEY.md §2.5/§7). Dead lanes keep computing
but write nothing — at Cornell-scene scale masking beats compaction; the
wavefront engine with compaction arrives with the LBVH milestone.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from henjou.bsdf.lambert import lambert_sample
from henjou.integrator.payload import Sky, SurfaceHit, closest_hit
from henjou.math.constants import TMAX_RAY, ray_eps
from henjou.math.vec import dot, local_to_world, orthonormal_basis, world_to_local
from henjou.sampling.cmj import CMJState, cmj_1d
from henjou.scene.scenedata import FrameScene

MAX_DEPTH = 10  # reference: rt.h:89


def default_bsdf_sample(hit: SurfaceHit, local_wo, state: CMJState):
    """M1 placeholder facade: Lambert-only (the commented-out baseline in the
    reference raygen, rt.h:145-149). Replaced by the full BSDF dispatch."""
    return lambert_sample(hit.basecolor, local_wo, state)


class PathtraceResult(NamedTuple):
    lte: jnp.ndarray  # [R,3] radiance estimate
    aov_albedo: jnp.ndarray  # [R,3] first-hit basecolor
    aov_normal: jnp.ndarray  # [R,3] first-hit shading normal
    # scalar f32: traces a SIMT megakernel would have issued for this batch
    # (radiance per live lane; +shadow +bsdf-branch in NEE/MIS) — the honest
    # Mrays/s numerator (bench.py counts these, not an assumed depth)
    n_traces: jnp.ndarray = None


def pathtrace(
    frame: FrameScene,
    sky: Sky,
    ray_o: jnp.ndarray,
    ray_d: jnp.ndarray,
    state: CMJState,
    bsdf_sample: Callable = default_bsdf_sample,
    max_depth: int = MAX_DEPTH,
    intersect_fn=None,
) -> PathtraceResult:
    r = ray_o.shape[0]
    # ray-derived zeros keep loop-carry varying types consistent under
    # shard_map (see accel/traverse.py note)
    zero3 = (ray_o + ray_d) * 0.0

    eps_r = ray_eps(frame)  # scene-relative tmin (constants.ray_eps)

    def body(depth, carry):
        lte, thr, o, d, st, alive, aov_a, aov_n, n_tr = carry

        # Russian roulette on max throughput (rt.h:96-102); the sample is
        # drawn before the trace, matching the reference stream order.
        u_rr, st = cmj_1d(st)
        russian_p = jnp.max(thr, axis=-1)
        survive = russian_p >= u_rr
        alive = alive & survive
        thr = thr / jnp.maximum(russian_p, 1e-12)[:, None]
        n_tr = n_tr + jnp.sum(alive.astype(jnp.float32))  # radiance trace

        # dead lanes trace with tmax=0: the intersector's skip test then
        # eliminates their work entirely (results are masked anyway)
        lane_tmax = jnp.where(alive, TMAX_RAY, 0.0)
        hit = closest_hit(frame, sky, o, d, eps_r, lane_tmax, intersect_fn)

        first = depth == 0
        aov_a = jnp.where(first, hit.basecolor, aov_a)
        aov_n = jnp.where(first, hit.normal, aov_n)

        # Miss -> sky emission; light hit -> emitter radiance. Both terminate
        # (rt.h:118-126).
        terminal = (~hit.is_hit) | hit.is_light
        add = alive & terminal
        lte = lte + jnp.where(add[:, None], thr * hit.emission, 0.0)
        alive = alive & ~terminal

        # BSDF bounce
        n = hit.normal
        t, b = orthonormal_basis(n)
        local_wo = world_to_local(-d, t, n, b)
        bsdf, local_wi, pdf, st = bsdf_sample(hit, local_wo, st)
        wi = local_to_world(local_wi, t, n, b)
        weight = bsdf * (jnp.abs(dot(wi, n)) / jnp.maximum(pdf, 1e-12))[:, None]
        thr = jnp.where(alive[:, None], thr * weight, thr)
        o = jnp.where(alive[:, None], hit.position, o)
        d = jnp.where(alive[:, None], wi, d)
        return (lte, thr, o, d, st, alive, aov_a, aov_n, n_tr)

    init = (
        zero3,
        1.0 + zero3,
        ray_o + zero3,
        ray_d + zero3,
        state,
        zero3[:, 0] == 0.0,
        zero3,
        zero3,
        jnp.sum(zero3[:, 0]),
    )
    lte, _, _, _, _, _, aov_a, aov_n, n_tr = jax.lax.fori_loop(
        0, max_depth, body, init
    )
    return PathtraceResult(
        lte=lte, aov_albedo=aov_a, aov_normal=aov_n, n_traces=n_tr
    )
