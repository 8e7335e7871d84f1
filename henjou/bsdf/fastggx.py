"""FastMultipleGGX: cheap analytic multiple-scattering compensation.

Parity port of the reference's FastMultipleGGX (BSDFs.h:854-977): a
single-scatter GGX lobe plus a centroid-direction compensation term
(`multipleG`, BSDFs.h:906-911; approximate NDF at the half-centroid
angle, BSDFs.h:913-916). Present and instantiated in the reference facade
but its sample path is commented out there (BSDFs.h:1027) — kept here
with the same status: available, not routed by default dispatch.
"""

from __future__ import annotations

import jax.numpy as jnp

from henjou.bsdf.ggx import ggx_alpha
from henjou.bsdf.microfacet import (
    ggx_d,
    ggx_g1,
    ggx_g2_height_correlated,
    sample_visible_normal,
)
from henjou.math.constants import PI
from henjou.math.vec import absdot, dot, normalize, reflect, schlick_fresnel
from henjou.sampling.cmj import CMJState, cmj_2d


def _multiple_g(wo, wi, wc):
    """Centroid-direction shadowing for the compensation lobe
    (BSDFs.h:906-911)."""
    theta_c = jnp.arccos(jnp.clip(dot(wo, wc), -1.0, 1.0))
    theta_m = (PI - jnp.arccos(jnp.clip(dot(wo, wi), -1.0, 1.0))) * 0.25
    op = jnp.sin(theta_c - theta_m) / jnp.maximum(
        jnp.sin(theta_c + theta_m), 1e-6
    )
    return 1.0 - jnp.maximum(0.0, op)


def _ggx_d_approx(mdot, alpha):
    """BSDFs.h:913-916."""
    a2 = alpha * alpha
    term1 = mdot * mdot * (a2 - 1.0) + 1.0
    return a2 / (PI * term1 * term1)


def fast_ggx_eval(F0, roughness, wo, wi):
    """Single-scatter part only (BSDFs.h:928-936)."""
    alpha = ggx_alpha(roughness)
    wm = normalize(wo + wi)
    d = ggx_d(wm, alpha)
    g2 = ggx_g2_height_correlated(wi, wo, alpha)
    f = schlick_fresnel(F0, wi, wm)
    denom = 4.0 * wo[..., 1] * wi[..., 1]
    return (d * g2 / jnp.where(jnp.abs(denom) > 1e-12, denom, 1e-12))[..., None] * f


def fast_ggx_sample(F0, roughness, wo, state: CMJState):
    """VNDF sample + analytic multi-scatter compensation (BSDFs.h:938-971).
    Returns (bsdf[R,3], wi[R,3], pdf[R], state)."""
    alpha = ggx_alpha(roughness)
    xi, state = cmj_2d(state)
    wm = sample_visible_normal(xi, wo, alpha)
    wi = reflect(-wo, wm)
    below = wi[..., 1] <= 0.0

    d = ggx_d(wm, alpha)
    g2 = ggx_g2_height_correlated(wi, wo, alpha)
    f = schlick_fresnel(F0, wi, wm)
    denom = 4.0 * wo[..., 1] * wi[..., 1]
    bsdf = (d * g2 / jnp.where(jnp.abs(denom) > 1e-12, denom, 1e-12))[..., None] * f

    jac = 0.25 / jnp.maximum(absdot(wo, wm), 1e-12)
    g1 = ggx_g1(wo, alpha)
    pdf = d * g1 * absdot(wo, wm) * jac / jnp.maximum(jnp.abs(wo[..., 1]), 1e-12)

    # compensation lobe about the half-centroid direction (BSDFs.h:962-968)
    up = jnp.zeros_like(wm).at[..., 1].set(1.0)
    wc = normalize(up + wm)
    gi = _multiple_g(wo, wi, wc)
    theta_m = (PI - jnp.arccos(jnp.clip(dot(wo, wi), -1.0, 1.0))) * 0.25
    di = _ggx_d_approx(jnp.cos(theta_m), alpha)
    bsdf = bsdf + (di * gi / jnp.maximum(2.0 * dot(wc, wo), 1e-6))[..., None] * f * f

    bsdf = jnp.where(below[..., None], 0.0, bsdf)
    pdf = jnp.where(below, 1.0, pdf)
    return bsdf, wi, pdf, state
