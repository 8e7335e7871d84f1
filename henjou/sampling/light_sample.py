"""Area-light sampling (reference: include/kernel/light_sample.h).

Uniform pick over the emissive-triangle list, then a uniform barycentric
point sample; pdf = 1/(area * N_lights) (light_sample.h:40,69-70).

The reference recovers the owning instance with a binary search of
prim_offsets (light_sample.h:26-42) and applies the instance transform to
object-space vertices. Here the FrameScene already holds *world-space*
triangles indexed by global prim id (the per-frame flatten), so the gather
replaces both the search and the transform — same result, one memory op.
"""

from __future__ import annotations

import os

import jax.numpy as jnp

from henjou.accel.lbvh import LBVH, build_lbvh
from henjou.math.vec import cross, length, normalize
from henjou.sampling.cmj import CMJState, cmj_1d, cmj_2d
from henjou.scene.scenedata import FrameScene
from typing import NamedTuple

# Light SELECTION strategy. The reference picks uniformly over the
# emissive list (light_sample.h:40); "power" importance-samples each
# light by luminance x world area instead — same estimator contract
# (pdfs adjust everywhere, MIS stays balanced), strictly lower variance
# when lights differ in brightness or size (a contest scene regime).
# Draw counts are identical, so CMJ stream parity with the reference's
# sampler is preserved. Set HENJOU_LIGHT_SAMPLING=uniform for exact
# reference selection behavior.
LIGHT_SAMPLING = os.environ.get("HENJOU_LIGHT_SAMPLING", "power")

_LUM = (0.2126, 0.7152, 0.0722)


def _luminance(rgb):
    """Rec.709 luminance over the last axis, as multiply+sum (a float32
    matmul may run as TF32 on a GPU)."""
    return rgb[..., 0] * _LUM[0] + rgb[..., 1] * _LUM[1] + rgb[..., 2] * _LUM[2]


def _light_select_dist(frame: FrameScene):
    """Per-light selection weights for the active strategy: returns
    (w_norm[L], cdf[L]) with w_norm summing to 1, or None for uniform
    selection. Everything is a cheap [L]-sized, lane-count-free
    computation on loop-invariant inputs — XLA hoists it out of the
    bounce loop."""
    if LIGHT_SAMPLING != "power":
        return None
    dev = frame.device
    n_l = int(dev.light_prim_ids.shape[0])
    if n_l == 0:
        return None
    tv = frame.tri_verts[dev.light_prim_ids]  # [L,3,3] world
    area = 0.5 * length(cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]))
    lum = _luminance(dev.light_prim_emission)
    w = jnp.maximum(lum, 0.0) * jnp.maximum(area, 0.0)
    # mask any padding rows beyond the true light count
    w = jnp.where(
        jnp.arange(n_l) < dev.num_lights, w, 0.0
    )
    total = jnp.sum(w)
    # degenerate scenes (all-zero luminance) fall back to uniform
    count = jnp.maximum(jnp.asarray(dev.num_lights, jnp.float32), 1.0)
    uniform = jnp.where(jnp.arange(n_l) < dev.num_lights, 1.0 / count, 0.0)
    w_norm = jnp.where(total > 0.0, w / jnp.maximum(total, 1e-30), uniform)
    return w_norm, jnp.cumsum(w_norm)


def light_selection_prob_by_prim(frame: FrameScene) -> jnp.ndarray:
    """[T] per-PRIM selection probability table (0 for non-lights): the
    reverse-pdf ingredient for MIS when a BSDF ray hits a light
    (getLightPDF, light_sample.h:77-92 generalizes from 1/N to p_i).
    Loop-invariant; callers gather one value per lane."""
    dev = frame.device
    t = frame.tri_verts.shape[0]
    dist = _light_select_dist(frame)
    if dist is None:
        count = jnp.asarray(dev.num_lights, jnp.float32)
        n_l = int(dev.light_prim_ids.shape[0])
        p = jnp.where(
            jnp.arange(n_l) < dev.num_lights, 1.0 / jnp.maximum(count, 1.0), 0.0
        )
    else:
        p = dist[0]
    return jnp.zeros((t,), jnp.float32).at[dev.light_prim_ids].set(p)


def sample_light(frame: FrameScene, state: CMJState):
    """Returns (position[R,3], normal[R,3], emission[R,3], pdf[R], valid[R],
    state). valid=False when the scene has no emissive triangles
    (light_sample.h:12-16 pdf=-1 guard, made explicit)."""
    dev = frame.device
    count = jnp.asarray(dev.num_lights, jnp.float32)

    p, state = cmj_1d(state)
    r = p.shape[0]
    n_l = int(dev.light_prim_ids.shape[0])
    dist = _light_select_dist(frame) if n_l > 0 else None
    if dist is None:
        idx = (p * count).astype(jnp.int32)
        idx = jnp.clip(idx, 0, jnp.maximum(dev.num_lights - 1, 0))
        sel_p = jnp.full((r,), 1.0 / jnp.maximum(count, 1.0))
    else:
        w_norm, cdf = dist
        if n_l <= 512:
            # CDF inversion as a dense [R, L] compare-count
            idx = jnp.sum(
                (p[:, None] >= cdf[None, :]).astype(jnp.int32), axis=1
            )
        else:
            idx = jnp.searchsorted(cdf, p, side="right").astype(jnp.int32)
        idx = jnp.clip(idx, 0, jnp.maximum(dev.num_lights - 1, 0))
        sel_p = w_norm[idx]
    prim = dev.light_prim_ids[idx]
    v = frame.tri_verts[prim]  # [R,3,3] world
    n = frame.tri_normals[prim]
    emission = dev.light_prim_emission[idx]

    xi, state = cmj_2d(state)
    sq = jnp.sqrt(xi[..., 0])
    f1 = (1.0 - sq)[..., None]
    f2 = (sq * (1.0 - xi[..., 1]))[..., None]
    f3 = (sq * xi[..., 1])[..., None]

    position = v[:, 0] * f1 + v[:, 1] * f2 + v[:, 2] * f3
    normal = normalize(n[:, 0] * f1 + n[:, 1] * f2 + n[:, 2] * f3)

    area = 0.5 * length(cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]))
    pdf = sel_p / jnp.maximum(area, 1e-12)

    valid = jnp.broadcast_to(count > 0.5, pdf.shape)
    return position, normal, emission, pdf, valid, state


def sample_light_ris(
    frame: FrameScene,
    state: CMJState,
    shade_pos: jnp.ndarray,
    shade_n: jnp.ndarray,
    m: int,
):
    """Resampled importance sampling (RIS/WRS, Talbot 2005) over `m`
    independent light candidates: each lane draws m samples from the
    base strategy (sample_light — uniform or power-weighted selection),
    weights each by its UNSHADOWED geometric contribution at the lane's
    shading point, and keeps one proportional to weight. No extra
    traces — the single shadow ray is cast by the caller as usual; the
    m-fold cost is pure elementwise math plus m-1 extra sampler draws.

    Target function p_hat = luminance(emission) * |cos_surf| *
    |cos_light| / dist^2 — the same absolute cosines the NEE
    contribution uses (rt.h:240-247 takes fabs of both), so p_hat > 0
    wherever the contribution is nonzero and the RIS estimator stays
    unbiased. The BSDF factor is deliberately left out of the target
    (m uber-material evaluations per bounce would dominate the win).

    Returns (position[R,3], normal[R,3], emission[R,3], pdf_eff[R],
    pdf_src[R], valid[R], state):

    - pdf_eff: divide the contribution by this (RIS effective density
      p_hat_k * m / sum_j w_j).
    - pdf_src: the chosen candidate's PLAIN area pdf, for the MIS
      balance weight. MIS weights need only be a partition of unity in
      the sample point for unbiasedness (Veach 9.2.4), so the weights
      keep using the closed-form base pdf on both branches — the RIS
      technique's true marginal has no closed form. Slightly
      suboptimal weighting, zero bias.

    The reference has no analogue (light_sample.h draws exactly one
    uniform candidate); it answers many-light variance with arithmetic
    where the RT-core budget would instead buy more shadow rays.
    """
    r = shade_pos.shape[0]
    cand = []
    for _ in range(m):
        pos, nrm, emi, pdf, cvalid, state = sample_light(frame, state)
        cand.append((pos, nrm, emi, pdf, cvalid))
    pos = jnp.stack([c[0] for c in cand], 1)  # [R,m,3]
    nrm = jnp.stack([c[1] for c in cand], 1)
    emi = jnp.stack([c[2] for c in cand], 1)
    pdf = jnp.stack([c[3] for c in cand], 1)  # [R,m]
    vld = jnp.stack([c[4] for c in cand], 1)  # [R,m] bool

    to_l = pos - shade_pos[:, None, :]
    d2 = jnp.maximum(jnp.sum(to_l * to_l, -1), 1e-12)
    ldir = to_l / jnp.sqrt(d2)[..., None]
    cos1 = jnp.abs(jnp.sum(ldir * shade_n[:, None, :], -1))
    cos2 = jnp.abs(jnp.sum(-ldir * nrm, -1))
    lum = _luminance(emi)
    p_hat = lum * cos1 * cos2 / d2  # [R,m]

    w = jnp.where(pdf > 0.0, p_hat / jnp.maximum(pdf, 1e-30), 0.0)
    wsum = jnp.sum(w, axis=1)  # [R]
    u, state = cmj_1d(state)
    cdf = jnp.cumsum(w, axis=1)
    k = jnp.sum((cdf < (u * wsum)[:, None]).astype(jnp.int32), axis=1)
    k = jnp.clip(k, 0, m - 1)

    onehot = (
        k[:, None] == jnp.arange(m, dtype=jnp.int32)[None, :]
    ).astype(jnp.float32)  # [R,m]
    position = jnp.sum(onehot[..., None] * pos, axis=1)
    normal = jnp.sum(onehot[..., None] * nrm, axis=1)
    emission = jnp.sum(onehot[..., None] * emi, axis=1)
    p_hat_k = jnp.sum(onehot * p_hat, axis=1)
    pdf_src = jnp.sum(onehot * pdf, axis=1)

    # effective density of the resampled draw; wsum==0 means every
    # candidate had zero unshadowed contribution — the lane's correct
    # estimate is exactly 0, signalled via valid=False. Validity is the
    # CHOSEN candidate's flag (gathered via the same onehot), not the
    # last loop iteration's — today sample_light's valid is lane-uniform
    # ("scene has lights"), but this stays correct if it ever isn't.
    pdf_eff = p_hat_k * m / jnp.maximum(wsum, 1e-30)
    valid_k = jnp.sum(onehot * vld.astype(jnp.float32), axis=1) > 0.5
    valid = valid_k & (wsum > 0.0)
    return position, normal, emission, pdf_eff, pdf_src, valid, state


def light_pdf(frame: FrameScene, prim: jnp.ndarray) -> jnp.ndarray:
    """Reverse pdf for MIS (getLightPDF, light_sample.h:77-92): the area
    pdf of having light-sampled the triangle actually hit by a BSDF ray —
    selection probability (uniform 1/N or power-weighted) over its area."""
    # gather ONE precomputed area + one selection prob per lane instead of
    # nine vertex floats; both [T] tables are loop-invariant (XLA hoists
    # them out of the bounce loop)
    tv = frame.tri_verts
    areas = 0.5 * length(cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]))
    safe = jnp.maximum(prim, 0)
    sel_p = light_selection_prob_by_prim(frame)[safe]
    return sel_p / jnp.maximum(areas[safe], 1e-12)


# dense-[R, chunk] block width for intersect_lights: bounds the peak
# intermediate to [R, 512] (≈134 MB f32 at 64k lanes) however many
# emissive triangles the scene has (the old uncapped [R, L] path
# materialized ≈8 GB at L=10k and OOMed)
LIGHT_CHUNK = 512


def intersect_lights(frame: FrameScene, ray_o, ray_d, tmin, tmax):
    """Closest hit against EMISSIVE triangles only: dense Moller-Trumbore
    in [R, <=512] chunks, no acceleration structure.

    The MIS BSDF-branch trace (rt.h:382-420) only USES its hit when the
    hit is a light (or a miss); so the wavefront engine traces lights
    densely here and resolves occlusion with a cheap bounded any-hit
    query instead of a full closest-hit kernel walk. Light counts above
    LIGHT_CHUNK run as an unrolled chunk loop with a running best-hit,
    so memory stays flat in L (compute is still O(R*L): scenes with
    thousands of mesh lights use the emissive-subset LBVH instead,
    `make_light_intersector`).

    Returns (t, prim, u, v, hit, area) — the intersector contract plus
    the hit light's triangle area (for the MIS reverse pdf).
    """
    import jax.numpy as jnp

    dev = frame.device
    n = ray_o.shape[0]
    n_l = int(dev.light_prim_ids.shape[0])
    # light_prim_ids is padded to shape (1,) for zero-light scenes
    # (scenedata.build_device_scene), so gate on the STATIC true count
    if int(dev.num_lights) == 0:
        n_l = 0
    if n_l == 0:
        zero = jnp.zeros((n,), jnp.float32)
        return (
            jnp.full((n,), jnp.inf),
            jnp.full((n,), -1, jnp.int32),
            zero,
            zero,
            jnp.zeros((n,), bool),
            zero,
        )
    lp = dev.light_prim_ids
    tv = frame.tri_verts[lp]  # [L,3,3] loop-invariant (XLA hoists)
    o = ray_o[:, None, :]
    d = ray_d[:, None, :]
    tmin_b = jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), (n,))[:, None]
    tmax_b = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (n,))[:, None]

    t_best = jnp.full((n,), jnp.inf)
    u_b = jnp.zeros((n,), jnp.float32)
    v_b = jnp.zeros((n,), jnp.float32)
    prim_b = jnp.full((n,), -1, jnp.int32)
    area_b = jnp.zeros((n,), jnp.float32)

    for c0 in range(0, n_l, LIGHT_CHUNK):
        c1 = min(c0 + LIGHT_CHUNK, n_l)
        nc = c1 - c0
        tvc = tv[c0:c1]
        v0 = tvc[:, 0][None]  # [1,C,3]
        e1 = (tvc[:, 1] - tvc[:, 0])[None]
        e2 = (tvc[:, 2] - tvc[:, 0])[None]

        pv = jnp.cross(d, e2)
        det = jnp.sum(e1 * pv, -1)
        inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
        tvec = o - v0
        uu = jnp.sum(tvec * pv, -1) * inv_det
        qv = jnp.cross(tvec, e1)
        vv = jnp.sum(d * qv, -1) * inv_det
        tt = jnp.sum(e2 * qv, -1) * inv_det
        ok = (
            (jnp.abs(det) > 1e-12)
            & (uu >= 0.0)
            & (vv >= 0.0)
            & (uu + vv <= 1.0)
            & (tt > tmin_b)
            & (tt < tmax_b)
        )
        tt = jnp.where(ok, tt, jnp.inf)
        t_c = jnp.min(tt, axis=1)
        li = jnp.argmin(tt, axis=1)
        pick = (
            jnp.arange(nc, dtype=jnp.int32)[None, :] == li[:, None]
        )
        u_c = jnp.sum(jnp.where(pick, uu, 0.0), axis=1)
        v_c = jnp.sum(jnp.where(pick, vv, 0.0), axis=1)
        prim_c = jnp.sum(
            jnp.where(pick, lp[None, c0:c1].astype(jnp.int32), 0), axis=1
        ).astype(jnp.int32)
        # area of the picked light (for the MIS reverse pdf): selecting
        # from the [C] table avoids an [R]-row gather in light_pdf
        area_l = 0.5 * jnp.linalg.norm(
            jnp.cross(e1[0], e2[0]), axis=-1
        )  # [C]
        area_c = jnp.sum(jnp.where(pick, area_l[None], 0.0), axis=1)

        better = t_c < t_best
        t_best = jnp.where(better, t_c, t_best)
        u_b = jnp.where(better, u_c, u_b)
        v_b = jnp.where(better, v_c, v_b)
        prim_b = jnp.where(better, prim_c, prim_b)
        area_b = jnp.where(better, area_c, area_b)

    hit = jnp.isfinite(t_best)
    return (
        jnp.where(hit, t_best, jnp.inf),
        jnp.where(hit, prim_b, -1),
        u_b,
        v_b,
        hit,
        area_b,
    )


class LightAccel(NamedTuple):
    """LBVH over the EMISSIVE triangle subset, plus the subset->global
    prim map and per-light areas. A pytree: passes through jit boundaries
    as an argument, so animated scenes refresh it per frame without
    retracing the engine."""

    bvh: LBVH  # over tri_verts[light_prim_ids]
    light_prim_ids: jnp.ndarray  # [L] i32 global prim ids
    areas: jnp.ndarray  # [L] f32


def build_light_accel(tri_verts, light_prim_ids) -> LightAccel:
    """Build the emissive-subset LBVH on the device (jittable)."""
    ids = jnp.asarray(light_prim_ids, jnp.int32)
    sub = jnp.asarray(tri_verts, jnp.float32)[ids]
    return LightAccel(
        bvh=build_lbvh(sub),
        light_prim_ids=ids,
        areas=0.5 * length(cross(sub[:, 1] - sub[:, 0], sub[:, 2] - sub[:, 0])),
    )


def make_light_intersector(light_accel: LightAccel):
    """Accelerated replacement for `intersect_lights` when the scene has
    MANY emissive triangles: trace the emissive SUBSET with the backend's
    LBVH traversal (accel/route.py), so the MIS BSDF-branch light query
    costs O(R log L) instead of the dense O(R*L) Moller-Trumbore.

    Returns light_isect(frame, o, d, tmin, tmax) with the
    intersect_lights contract (t, GLOBAL prim id, u, v, hit, area).
    Reference counterpart: the branch trace is a full optixTrace there
    (rt.h:396); this specializes it to the emissive geometry only."""
    from henjou.accel.route import make_intersectors

    isect, _ = make_intersectors(light_accel.bvh)

    def light_isect(frame, ray_o, ray_d, tmin, tmax):
        t, p, u, v, h = isect(None, ray_o, ray_d, tmin, tmax)
        safe = jnp.maximum(p, 0)
        prim_g = jnp.where(h, light_accel.light_prim_ids[safe], -1)
        area = jnp.where(h, light_accel.areas[safe], 0.0)
        return t, prim_g, u, v, h, area

    return light_isect
