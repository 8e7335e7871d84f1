"""Next-event-estimation integrator (reference: rt.h:162-281).

Per bounce: explicit light sample + shadow ray, then a BSDF bounce; direct
emitter/sky hits only count at depth 0 (rt.h:196-208). Same wavefront
masking shape as pathtrace.py.

Stream-parity note: the reference draws one unused 2D sample right before
sampleBSDF (rt.h:266) — a dead draw left in the original; we reproduce it
so per-lane random streams match.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from henjou.bsdf.dispatch import bsdf_eval as default_bsdf_eval
from henjou.bsdf.dispatch import bsdf_sample as default_bsdf_sample
from henjou.integrator.pathtrace import MAX_DEPTH, PathtraceResult
from henjou.integrator.payload import Sky, closest_hit, occluded
from henjou.math.constants import SHADOW_EPS_REL, TMAX_RAY, ray_eps
from henjou.math.vec import (
    absdot,
    dot,
    length,
    local_to_world,
    normalize,
    orthonormal_basis,
    world_to_local,
)
from henjou.sampling.cmj import CMJState, cmj_1d, cmj_2d
from henjou.sampling.light_sample import sample_light
from henjou.scene.scenedata import FrameScene


def nee(
    frame: FrameScene,
    sky: Sky,
    ray_o: jnp.ndarray,
    ray_d: jnp.ndarray,
    state: CMJState,
    bsdf_sample: Callable = default_bsdf_sample,
    bsdf_eval: Callable = default_bsdf_eval,
    max_depth: int = MAX_DEPTH,
    intersect_fn=None,
    occluded_fn=None,
) -> PathtraceResult:
    r = ray_o.shape[0]
    # ray-derived zeros: see accel/traverse.py shard_map carry note
    zero3 = (ray_o + ray_d) * 0.0

    eps_r = ray_eps(frame)  # scene-relative tmin (constants.ray_eps)

    def body(depth, carry):
        lte, thr, o, d, st, alive, aov_a, aov_n, n_tr = carry

        u_rr, st = cmj_1d(st)
        russian_p = jnp.max(thr, axis=-1)
        alive = alive & (russian_p >= u_rr)
        thr = thr / jnp.maximum(russian_p, 1e-12)[:, None]
        n_tr = n_tr + jnp.sum(alive.astype(jnp.float32))  # radiance trace

        lane_tmax = jnp.where(alive, TMAX_RAY, 0.0)  # dead-lane gating
        hit = closest_hit(frame, sky, o, d, eps_r, lane_tmax, intersect_fn)

        first = depth == 0
        aov_a = jnp.where(first, hit.basecolor, aov_a)
        aov_n = jnp.where(first, hit.normal, aov_n)

        # direct emitter/sky only at depth 0 (rt.h:196-208)
        terminal = (~hit.is_hit) | hit.is_light
        add = alive & terminal & first
        lte = lte + jnp.where(add[:, None], thr * hit.emission, 0.0)
        alive = alive & ~terminal
        n_tr = n_tr + jnp.sum(alive.astype(jnp.float32))  # shadow trace

        n = hit.normal
        t, b = orthonormal_basis(n)
        local_wo = world_to_local(-d, t, n, b)

        # ---- NEE (rt.h:218-260) ----
        l_pos, l_normal, l_emission, l_pdf, l_valid, st = sample_light(frame, st)
        to_light = l_pos - hit.position
        l_dist = jnp.maximum(length(to_light), 1e-12)
        l_dir = to_light / l_dist[:, None]
        shadow_blocked = occluded(
            frame, hit.position, l_dir, eps_r,
            jnp.where(alive, l_dist * (1.0 - SHADOW_EPS_REL), 0.0), occluded_fn
        )
        cos1 = absdot(n, l_dir)
        cos2 = absdot(l_normal, -l_dir)
        local_wi_l = world_to_local(l_dir, t, n, b)
        f_l = bsdf_eval(hit, local_wo, local_wi_l)
        g = cos2 / (l_dist * l_dist)
        contrib = thr * f_l * (g * cos1 / jnp.maximum(l_pdf, 1e-12))[:, None] * l_emission
        ok = alive & l_valid & ~shadow_blocked & (l_pdf > 0.0)
        lte = lte + jnp.where(ok[:, None], contrib, 0.0)

        # ---- BSDF bounce (rt.h:262-277) ----
        _dead, st = cmj_2d(st)  # rt.h:266 dead draw, kept for parity
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
