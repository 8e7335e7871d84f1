"""Single-scatter GGX BRDF with VNDF sampling (reference: BSDFs.h:35-138)."""

from __future__ import annotations

import jax.numpy as jnp

from henjou.bsdf.microfacet import (
    ggx_d,
    ggx_g2_height_correlated,
    sample_visible_normal,
    vndf_pdf,
)
from henjou.math.vec import normalize, reflect, schlick_fresnel
from henjou.sampling.cmj import CMJState, cmj_2d


def ggx_alpha(roughness):
    """alpha = clamp(roughness^2, 1e-4, 1) (reference: BSDFs.h:91-94)."""
    return jnp.clip(roughness * roughness, 1e-4, 1.0)


def ggx_eval(F0, roughness, wo, wi):
    """reference: BSDFs.h:96-104."""
    alpha = ggx_alpha(roughness)
    wm = normalize(wo + wi)
    d = ggx_d(wm, alpha)
    g2 = ggx_g2_height_correlated(wi, wo, alpha)
    f = schlick_fresnel(F0, wi, wm)
    denom = 4.0 * wo[..., 1] * wi[..., 1]
    return (d * g2 / jnp.where(jnp.abs(denom) > 1e-12, denom, 1e-12))[..., None] * f


def ggx_sample(F0, roughness, wo, state: CMJState):
    """VNDF importance sampling (reference: BSDFs.h:106-132).
    Returns (bsdf[R,3], wi[R,3], pdf[R], state)."""
    alpha = ggx_alpha(roughness)
    xi, state = cmj_2d(state)
    wm = sample_visible_normal(xi, wo, alpha)
    wi = reflect(-wo, wm)
    below = wi[..., 1] <= 0.0

    bsdf = ggx_eval(F0, roughness, wo, wi)
    pdf = vndf_pdf(wm, wo, alpha)

    bsdf = jnp.where(below[..., None], 0.0, bsdf)
    pdf = jnp.where(below, 1.0, pdf)
    return bsdf, wi, pdf, state


def ggx_pdf(roughness, wo, wi):
    """VNDF pdf of an arbitrary direction (the reference leaves getPDF
    unimplemented, BSDFs.h:134-136; provided here for MIS completeness)."""
    alpha = ggx_alpha(roughness)
    wm = normalize(wo + wi)
    return vndf_pdf(wm, wo, alpha)
