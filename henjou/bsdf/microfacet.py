"""Shared Trowbridge-Reitz (GGX) microfacet math.

One implementation for the distribution/shadowing terms duplicated across
the reference's GGX / EnagyConservationGGX / FastMultipleGGX / DisneyBRDF
classes (BSDFs.h:40-59,507-532,860-879; disneyBRDF.h:44-61). Shading space:
+Y = normal. Batched over rays; `alpha` broadcasts per lane.
"""

from __future__ import annotations

import jax.numpy as jnp

from henjou.math.constants import PI
from henjou.math.vec import normalize


def ggx_d(wm: jnp.ndarray, alpha) -> jnp.ndarray:
    """GGX NDF (reference: BSDFs.h:40-44)."""
    a2 = alpha * alpha
    term1 = (wm[..., 0] ** 2 + wm[..., 2] ** 2) / a2 + wm[..., 1] ** 2
    return 1.0 / (PI * a2 * term1 * term1)


def ggx_lambda(v: jnp.ndarray, alpha) -> jnp.ndarray:
    """Smith Lambda (reference: BSDFs.h:54-59). v.y == 0 lanes are guarded."""
    y2 = jnp.maximum(v[..., 1] ** 2, 1e-12)
    delta = 1.0 + alpha * alpha * (v[..., 0] ** 2 + v[..., 2] ** 2) / y2
    return (-1.0 + jnp.sqrt(delta)) * 0.5


def ggx_g1(v: jnp.ndarray, alpha) -> jnp.ndarray:
    return 1.0 / (1.0 + ggx_lambda(v, alpha))


def ggx_g2_height_correlated(wi, wo, alpha) -> jnp.ndarray:
    """Height-correlated Smith (reference: BSDFs.h:50-52)."""
    return 1.0 / (1.0 + ggx_lambda(wi, alpha) + ggx_lambda(wo, alpha))


def sample_visible_normal(xi: jnp.ndarray, wo: jnp.ndarray, alpha) -> jnp.ndarray:
    """Spherical-cap VNDF sampling (arXiv 2306.05044; reference:
    BSDFs.h:62-78). xi: [...,2] uniform, wo: shading-space view dir."""
    alpha = jnp.broadcast_to(jnp.asarray(alpha), wo.shape[:-1])
    stretch = jnp.stack(
        [wo[..., 0] * alpha, wo[..., 1], wo[..., 2] * alpha], axis=-1
    )
    swo = normalize(stretch)
    phi = 2.0 * PI * xi[..., 0]
    z = (1.0 - xi[..., 1]) * (1.0 + swo[..., 1]) - swo[..., 1]
    sin_t = jnp.sqrt(jnp.clip(1.0 - z * z, 0.0, 1.0))
    x = sin_t * jnp.cos(phi)
    y = sin_t * jnp.sin(phi)
    # cap sample in the reference's (x, z, y) layout with +Y up
    c = jnp.stack([x, z, y], axis=-1)
    h = c + swo
    wm = normalize(
        jnp.stack([h[..., 0] * alpha, h[..., 1], h[..., 2] * alpha], axis=-1)
    )
    return wm


def vndf_pdf(wm, wo, alpha) -> jnp.ndarray:
    """Visible-normal pdf for the reflected direction (reference:
    BSDFs.h:123-129): D * G1(wo) * |wo.wm| * J / |wo.y|, J = 1/(4|wo.wm|)."""
    d = ggx_d(wm, alpha)
    g1 = ggx_g1(wo, alpha)
    return 0.25 * d * g1 / jnp.maximum(jnp.abs(wo[..., 1]), 1e-12)
