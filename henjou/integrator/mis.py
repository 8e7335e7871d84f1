"""Multiple-importance-sampling integrator (reference: rt.h:284-440).

Per bounce, three traces like the original (renderer.h:193 raytypes;
rt.h:304,356,396):
  1. radiance ray (path continuation hit),
  2. NEE shadow ray, weighted by light_pdf/(light_pdf + bsdf_pdf*G)
     (rt.h:374-376, balance heuristic),
  3. an independent BSDF-sample ray whose emitter hits are weighted by
     pt_pdf/(pt_pdf + light_pdf*invG) (rt.h:383-420); on a miss this
     branch collects sky radiance unweighted (rt.h:417-419).
Specular lanes force light_pdf = 0 in branch 3 (rt.h:411) and contribute
nothing in branch 2 (delta eval == 0).
Direct emitter/sky hits on the radiance ray only count at depth 0
(rt.h:318-330). The continuation direction is drawn independently of
branch 3 (rt.h:422-436), including the original's dead 2D draw (rt.h:426).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from henjou.bsdf.dispatch import bsdf_eval as default_bsdf_eval
from henjou.bsdf.dispatch import bsdf_pdf as default_bsdf_pdf
from henjou.bsdf.dispatch import bsdf_sample as default_bsdf_sample
from henjou.integrator.pathtrace import MAX_DEPTH, PathtraceResult
from henjou.integrator.payload import Sky, closest_hit, occluded
from henjou.math.constants import SHADOW_EPS_REL, TMAX_RAY, ray_eps
from henjou.math.vec import (
    absdot,
    dot,
    length,
    local_to_world,
    orthonormal_basis,
    world_to_local,
)
from henjou.sampling.cmj import CMJState, cmj_1d, cmj_2d
from henjou.sampling.light_sample import light_pdf as light_pdf_fn
from henjou.sampling.light_sample import sample_light
from henjou.scene.scenedata import FrameScene


def mis(
    frame: FrameScene,
    sky: Sky,
    ray_o: jnp.ndarray,
    ray_d: jnp.ndarray,
    state: CMJState,
    bsdf_sample: Callable = default_bsdf_sample,
    bsdf_eval: Callable = default_bsdf_eval,
    bsdf_pdf: Callable = default_bsdf_pdf,
    max_depth: int = MAX_DEPTH,
    intersect_fn=None,
    occluded_fn=None,
) -> PathtraceResult:
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

        terminal = (~hit.is_hit) | hit.is_light
        add = alive & terminal & first
        lte = lte + jnp.where(add[:, None], thr * hit.emission, 0.0)
        alive = alive & ~terminal
        # shadow + bsdf-branch traces (rt.h:356,396)
        n_tr = n_tr + 2.0 * jnp.sum(alive.astype(jnp.float32))

        n = hit.normal
        t, b = orthonormal_basis(n)
        local_wo = world_to_local(-d, t, n, b)

        # ---- NEE branch (rt.h:340-380) ----
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
        pt_pdf_l = bsdf_pdf(hit, local_wo, local_wi_l) * g  # rt.h:374
        w_light = l_pdf / jnp.maximum(l_pdf + pt_pdf_l, 1e-12)
        contrib_nee = (
            thr
            * f_l
            * (g * cos1 / jnp.maximum(l_pdf, 1e-12) * w_light)[:, None]
            * l_emission
        )
        ok = alive & l_valid & ~shadow_blocked & (l_pdf > 0.0)
        lte = lte + jnp.where(ok[:, None], contrib_nee, 0.0)

        # ---- BSDF-sampling branch (rt.h:382-420) ----
        brdf_b, local_wi_b, pt_pdf_b, st = bsdf_sample(hit, local_wo, st)
        wi_b = local_to_world(local_wi_b, t, n, b)
        cos1_b = absdot(wi_b, n)
        hit_b = closest_hit(
            frame, sky, hit.position, wi_b, eps_r, lane_tmax, intersect_fn
        )
        # emitter hit: balance-weighted (rt.h:404-416)
        cos2_b = absdot(-wi_b, hit_b.normal)
        dist_b = jnp.maximum(length(hit_b.position - hit.position), 1e-12)
        inv_g = dist_b * dist_b / jnp.maximum(cos2_b, 1e-12)
        lp = jnp.where(
            hit.is_specular, 0.0, light_pdf_fn(frame, hit_b.primitive_id) * inv_g
        )
        w_bsdf = pt_pdf_b / jnp.maximum(pt_pdf_b + lp, 1e-12)
        contrib_hit = (
            thr
            * (w_bsdf * cos1_b / jnp.maximum(pt_pdf_b, 1e-12))[:, None]
            * hit_b.emission
            * brdf_b
        )
        # sky miss: unweighted env contribution (rt.h:417-419)
        contrib_miss = (
            thr * (cos1_b / jnp.maximum(pt_pdf_b, 1e-12))[:, None] * hit_b.emission * brdf_b
        )
        take_hit = alive & hit_b.is_hit & hit_b.is_light
        take_miss = alive & ~hit_b.is_hit
        lte = lte + jnp.where(
            take_hit[:, None],
            contrib_hit,
            jnp.where(take_miss[:, None], contrib_miss, 0.0),
        )

        # ---- path continuation (rt.h:422-436) ----
        _dead, st = cmj_2d(st)  # rt.h:426 dead draw, kept for parity
        bsdf_c, local_wi_c, pdf_c, st = bsdf_sample(hit, local_wo, st)
        wi_c = local_to_world(local_wi_c, t, n, b)
        weight = bsdf_c * (jnp.abs(dot(wi_c, n)) / jnp.maximum(pdf_c, 1e-12))[:, None]
        thr = jnp.where(alive[:, None], thr * weight, thr)
        o = jnp.where(alive[:, None], hit.position, o)
        d = jnp.where(alive[:, None], wi_c, d)
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
