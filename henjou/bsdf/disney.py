"""Disney principled BRDF (reference: include/kernel/disneyBRDF.h:16-327).

Lobes: diffuse + subsurface blend, GGX specular with
F0 = lerp(0.08, basecolor, metallic), sheen, fixed-gloss clearcoat — and
the thin-film branch (headline feature #1) that replaces the specular F0
with a LUT lookup keyed on (thickness = basecolor.x, cos theta)
(disneyBRDF.h:213-218).

Parameter mapping follows the reference constructor exactly
(disneyBRDF.h:165-177): alpha = clamp(roughness^2, 0.01, 1),
anisotropic = subsurface = 0 (hardcoded there too), clearcoatGloss = 1 so
clearcoatAlpha = 0.001.

Note: the reference computes `dot_wo_n` from wi (disneyBRDF.h:189) — a
transcription slip in the original that slightly darkens grazing diffuse.
We implement the correct |wo.y| (documented deviation; the white-furnace
test validates energy conservation).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp

from henjou.bsdf.microfacet import (
    ggx_d,
    ggx_g2_height_correlated,
    sample_visible_normal,
    vndf_pdf,
)
from henjou.math.constants import INV_PI, PI, PI2
from henjou.math.vec import absdot, lerp, normalize, reflect, schlick_fresnel
from henjou.sampling.cmj import CMJState, cmj_1d, cmj_2d

_CLEARCOAT_GLOSS = 1.0
_CLEARCOAT_ALPHA = 0.1 * (1.0 - _CLEARCOAT_GLOSS) + 0.001 * _CLEARCOAT_GLOSS


class DisneyParams(NamedTuple):
    """Per-lane Disney parameters (constructor, disneyBRDF.h:165-177)."""

    basecolor: jnp.ndarray  # [R,3]
    alpha: jnp.ndarray  # [R]
    metallic: jnp.ndarray  # [R]
    sheen: jnp.ndarray  # [R]
    clearcoat: jnp.ndarray  # [R]
    subsurface: jnp.ndarray  # [R]
    is_thinfilm: jnp.ndarray  # [R] bool


def disney_params(
    basecolor, roughness, metallic, sheen, clearcoat, is_thinfilm=None
) -> DisneyParams:
    r = jnp.asarray(roughness)
    if is_thinfilm is None:
        is_thinfilm = jnp.zeros(r.shape, jnp.bool_)
    return DisneyParams(
        basecolor=jnp.asarray(basecolor),
        alpha=jnp.clip(r * r, 0.01, 1.0),
        metallic=jnp.asarray(metallic),
        sheen=jnp.asarray(sheen),
        clearcoat=jnp.asarray(clearcoat),
        subsurface=jnp.zeros(r.shape, jnp.float32),  # hardcoded 0, :170
        is_thinfilm=is_thinfilm,
    )


def _f_t_schlick(wn, f90):
    """disneyBRDF.h:106-109."""
    delta = jnp.maximum(1.0 - wn, 0.0)
    return 1.0 + (f90 - 1.0) * delta**5


def _clearcoat_d(wm, alpha):
    """Log-normalized clearcoat NDF (disneyBRDF.h:131-139)."""
    a2 = alpha * alpha
    t = 1.0 + (a2 - 1.0) * wm[..., 1] ** 2
    return (a2 - 1.0) / (PI * jnp.log(a2) * t)


def _clearcoat_lambda(w, alpha):
    y2 = jnp.maximum(w[..., 1] ** 2, 1e-12)
    term1 = 1.0 + alpha * alpha * (w[..., 0] ** 2 + w[..., 2] ** 2) / y2
    return 0.5 * (-1.0 + jnp.sqrt(term1))


def _clearcoat_g2(wi, wo, alpha):
    return 1.0 / (1.0 + _clearcoat_lambda(wi, alpha) + _clearcoat_lambda(wo, alpha))


def _pdf_diffuse(wi):
    return jnp.abs(wi[..., 1]) * INV_PI


def _pdf_specular(wm, wo, alpha):
    return vndf_pdf(wm, wo, alpha)


def _pdf_clearcoat(wm, wo):
    """disneyBRDF.h:102-104."""
    return (
        _clearcoat_d(wm, _CLEARCOAT_ALPHA)
        * jnp.abs(wm[..., 1])
        / (4.0 * jnp.maximum(absdot(wm, wo), 1e-12))
    )


def _specular_f0(p: DisneyParams, wi, wm, lut: Optional[jnp.ndarray]):
    """F0 = lerp(0.08, basecolor, metallic), or the thin-film LUT
    (disneyBRDF.h:211-218)."""
    f0 = lerp(jnp.full_like(p.basecolor, 0.08), p.basecolor, p.metallic[..., None])
    if lut is not None:
        from henjou.texture.lut import sample_lut

        thickness = p.basecolor[..., 0]
        cosine = absdot(wi, wm)
        f0_film = sample_lut(lut, thickness, cosine)
        f0 = jnp.where(p.is_thinfilm[..., None], f0_film, f0)
    return f0


def disney_eval(
    p: DisneyParams,
    wo,
    wi,
    lut: Optional[jnp.ndarray] = None,
    has_sheen: bool = True,
    has_clearcoat: bool = True,
) -> jnp.ndarray:
    """disneyBRDF.h:179-235. has_sheen/has_clearcoat are STATIC scene facts
    (any material with a nonzero factor?) so zero-weight terms compile out
    — lockstep lanes pay for every compiled term."""
    wm = normalize(wo + wi)
    dot_wi_n = jnp.abs(wi[..., 1])
    dot_wo_n = jnp.abs(wo[..., 1])

    cosine_d = absdot(wi, wm)
    f_d90 = 0.5 + 2.0 * p.alpha * cosine_d * cosine_d

    f_tsi = _f_t_schlick(dot_wi_n, f_d90)
    f_tso = _f_t_schlick(dot_wo_n, f_d90)

    f_diffuse = p.basecolor * (f_tsi * f_tso * INV_PI)[..., None]

    deltacos = 1.0 / jnp.maximum(dot_wi_n + dot_wo_n, 1e-6) - 0.5
    f_subsurface = (
        p.basecolor * (INV_PI * 1.25 * (f_tsi * f_tso * deltacos + 0.5))[..., None]
    )

    f0 = _specular_f0(p, wi, wm, lut)
    d = ggx_d(wm, p.alpha)
    g2 = ggx_g2_height_correlated(wi, wo, p.alpha)
    f = schlick_fresnel(f0, wo, wm)
    f_specular = (
        0.25 * (d * g2 / jnp.maximum(dot_wo_n * dot_wi_n, 1e-9))[..., None] * f
    )

    diffuse_blend = lerp(f_diffuse, f_subsurface, p.subsurface[..., None])
    out = diffuse_blend * (1.0 - p.metallic[..., None]) + f_specular

    if has_sheen:
        delta = jnp.maximum(1.0 - cosine_d, 0.0)
        f_sheen = (p.sheen * delta**5)[..., None] * jnp.ones_like(p.basecolor)
        out = out + f_sheen * (1.0 - p.metallic[..., None])

    if has_clearcoat:
        ccd = _clearcoat_d(wm, _CLEARCOAT_ALPHA)
        ccg = _clearcoat_g2(wi, wo, 0.25)
        ccf = schlick_fresnel(jnp.full_like(f0, 0.04), wo, wm)
        f_clearcoat = (
            0.25  # the 0.25 inside clearcoat() (disneyBRDF.h:142-150)
            * (ccd * ccg / jnp.maximum(dot_wo_n * dot_wi_n, 1e-9))[..., None]
            * ccf
        ) * 0.25  # the extra 0.25 at the call site (disneyBRDF.h:229)
        out = out + f_clearcoat * p.clearcoat[..., None]
    return out


def _lobe_weights(p: DisneyParams):
    """Importance-sampling lobe weights (disneyBRDF.h:239-247): diffuse
    1-metallic, specular 0.5, clearcoat 0."""
    dw = 1.0 - p.metallic
    sw = jnp.full_like(dw, 0.5)
    cw = jnp.zeros_like(dw)
    total = dw + sw + cw
    return dw / total, sw / total, cw / total


def _sample_diffuse(xi):
    """Cosine sampling with the reference's exact construction
    (disneyBRDF.h:30-38)."""
    theta = 0.5 * jnp.arccos(jnp.clip(1.0 - 2.0 * xi[..., 0], -1.0, 1.0))
    phi = PI2 * xi[..., 1]
    ct = jnp.cos(theta)
    st = jnp.sin(theta)
    return jnp.stack([jnp.cos(phi) * st, ct, jnp.sin(phi) * st], axis=-1)


def _sample_clearcoat_wm(xi):
    """disneyBRDF.h:93-100."""
    a2 = _CLEARCOAT_ALPHA * _CLEARCOAT_ALPHA
    ct = jnp.sqrt(jnp.maximum((1.0 - a2 ** (1.0 - xi[..., 0])) / (1.0 - a2), 0.0))
    st = jnp.sqrt(jnp.maximum(1.0 - ct * ct, 0.0))
    phi = PI2 * xi[..., 1]
    return jnp.stack([jnp.cos(phi) * st, ct, jnp.sin(phi) * st], axis=-1)


def disney_sample(
    p: DisneyParams,
    wo,
    state: CMJState,
    lut: Optional[jnp.ndarray] = None,
    has_sheen: bool = True,
    has_clearcoat: bool = True,
):
    """Lobe-mixture sampling (disneyBRDF.h:237-307). Branch-free: every
    lane evaluates the lobe candidates, then selects — RNG consumption (one
    1D + one 2D draw) is identical across lanes and branches, matching the
    reference stream. The clearcoat SAMPLING branch is statically dead in
    the reference (clearcoatWeight = 0, disneyBRDF.h:241, so dw+sw = 1 and
    select_p never reaches it) and is omitted here.
    Returns (bsdf[R,3], wi[R,3], pdf[R], state)."""
    dw, sw, _cw = _lobe_weights(p)
    select_p, state = cmj_1d(state)
    xi, state = cmj_2d(state)

    wi_diff = _sample_diffuse(xi)
    wm_spec = sample_visible_normal(xi, wo, p.alpha)
    wi_spec = reflect(-wo, wm_spec)

    take_diffuse = select_p < dw
    wi = jnp.where(take_diffuse[..., None], wi_diff, wi_spec)
    wm = normalize(wo + wi)

    pdf_d = _pdf_diffuse(wi)
    pdf_s = _pdf_specular(wm, wo, p.alpha)
    pdf = dw * pdf_d + sw * pdf_s

    below = wi[..., 1] < 0.0
    bsdf = disney_eval(p, wo, wi, lut, has_sheen, has_clearcoat)
    bsdf = jnp.where(below[..., None], 0.0, bsdf)
    pdf = jnp.where(below, 1.0, pdf)
    return bsdf, wi, pdf, state


def disney_pdf(p: DisneyParams, wo, wi):
    """MIS pdf (disneyBRDF.h:309-326): diffuse+specular mixture only."""
    dw, sw, _ = _lobe_weights(p)
    wm = normalize(wo + wi)
    return dw * _pdf_diffuse(wi) + sw * _pdf_specular(wm, wo, p.alpha)
