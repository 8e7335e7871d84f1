"""Gather-based bilinear texture sampling.

Replacement for cudaTextureObject_t fetches (reference textureBind,
renderer.h:740-800: normalized coords, wrap addressing, bilinear filter).
sRGB decode happens at *load* time here (textures are stored as f32 in
HBM), rather than at sample time in the TMU — same math, different place.
"""

from __future__ import annotations

import jax.numpy as jnp


def sample_bilinear_wrap(tex: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray):
    """tex: [H,W,C] f32. u,v: [...] normalized coords (wrap). Returns [...,C].

    Texel centers at (i+0.5)/W, matching CUDA's normalized-coordinate
    bilinear convention."""
    h, w = tex.shape[0], tex.shape[1]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = x0.astype(jnp.int32)
    y0 = y0.astype(jnp.int32)
    x1 = (x0 + 1) % w
    y1 = (y0 + 1) % h
    x0 = x0 % w
    y0 = y0 % h
    t00 = tex[y0, x0]
    t10 = tex[y0, x1]
    t01 = tex[y1, x0]
    t11 = tex[y1, x1]
    top = t00 * (1.0 - fx) + t10 * fx
    bot = t01 * (1.0 - fx) + t11 * fx
    return top * (1.0 - fy) + bot * fy
