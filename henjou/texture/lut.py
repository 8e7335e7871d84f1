"""Thin-film interference LUT (headline feature #1).

The reference precomputes spectral thin-film iridescence into a PNG LUT
indexed by (film thickness, cos theta) and swaps it in for the Disney
specular F0 (disneyBRDF.h:11-14,213-218; bound NonColor at
renderer.h:854-898). Here the LUT is a [H,W,3] f32 array sampled
bilinearly with wrap addressing, identical lookup semantics.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from henjou.texture.sampler import sample_bilinear_wrap


def load_lut_png(path: str) -> jnp.ndarray:
    """Load the LUT PNG as NonColor (no sRGB decode — renderer.h:894)."""
    from henjou.post.png import read_png

    img = read_png(path)
    rgb = img[..., :3].astype(np.float32) / 255.0
    return jnp.asarray(rgb)


def default_lut() -> jnp.ndarray:
    """Fallback when no LUT file is configured: a physically-motivated
    analytic Airy-reflectance LUT computed at build time (thin film of
    ior 1.5 on ior 1.0 substrate, thickness 0..1000nm over u, cos theta
    over v), RGB at 612/549/465nm. Gives plausible iridescence without
    the asset."""
    n_film = 1.5
    thick = np.linspace(0.0, 1000.0, 256)[None, :, None]  # nm, u axis
    cos_t = np.linspace(1e-3, 1.0, 256)[:, None, None]  # v axis
    wavelengths = np.asarray([612.0, 549.0, 465.0])[None, None, :]

    sin2 = (1.0 - cos_t**2) / (n_film**2)
    cos_f = np.sqrt(np.maximum(1.0 - sin2, 0.0))
    # Fresnel (s+p average) at both interfaces, normal-ish approximation
    r01 = ((1.0 - n_film) / (1.0 + n_film)) ** 2
    r01 = r01 + (1.0 - r01) * (1.0 - cos_t) ** 5
    phase = 4.0 * np.pi * n_film * thick * cos_f / wavelengths
    # Airy summation, two-beam approximation
    refl = 2.0 * r01 * (1.0 + np.cos(phase)) / (1.0 + r01**2 * (1 + np.cos(phase)))
    return jnp.asarray(np.clip(refl, 0.0, 1.0).astype(np.float32))


def sample_lut(lut: jnp.ndarray, thickness, cosine) -> jnp.ndarray:
    """getLUT analogue (disneyBRDF.h:11-14): u=thickness, v=cos theta."""
    return sample_bilinear_wrap(lut, thickness, cosine)
