"""Lambert BSDF (debug/baseline lobe, reference: BSDFs.h:13-33).

All BSDFs in this package share one convention: directions are in shading
space (+Y = normal), every function is batched over the ray dimension, and
sampling threads the CMJ state functionally.
"""

from __future__ import annotations

import jax.numpy as jnp

from henjou.math.constants import INV_PI
from henjou.math.vec import cosine_sampling
from henjou.sampling.cmj import CMJState, cmj_2d


def lambert_eval(basecolor, wo, wi):
    return basecolor * INV_PI


def lambert_sample(basecolor, wo, state: CMJState):
    """Returns (bsdf[R,3], wi[R,3], pdf[R], state)."""
    xi, state = cmj_2d(state)
    wi, pdf = cosine_sampling(xi[..., 0], xi[..., 1])
    return basecolor * INV_PI, wi, pdf, state


def lambert_pdf(wo, wi):
    return jnp.abs(wi[..., 1]) * INV_PI
