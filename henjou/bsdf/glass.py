"""Smooth dielectric BSDFs: IdealGlass and the minus-IOR MetaMaterialGlass.

MetaMaterialGlass is headline feature #2 of the reference (README.md:7-9):
identical to IdealGlass except the *refracted* ray is mirrored about the
inverted normal (reference: BSDFs.h:453-455, `reflect(-t, (0,-1,0))`),
which reproduces a negative-index medium. Algebraically that mirror is
(t.x, t.y, t.z) -> (-t.x, t.y, -t.z), i.e. a horizontal flip of the
transmitted direction, which is how it's written here (branch-free).

Both are delta distributions: evaluate() == 0 and pdf() == 0
(BSDFs.h:394-400,471-478), so NEE skips them and MIS treats them as
specular (rt.h:411).
"""

from __future__ import annotations

import jax.numpy as jnp

from henjou.math.vec import reflect, refract, schlick_fresnel_ior
from henjou.sampling.cmj import CMJState, cmj_1d

_UP = jnp.asarray([0.0, 1.0, 0.0])


def _glass_sample(rho, ior, wo, state: CMJState, meta: bool):
    """Common body of IdealGlass/MetaMaterialGlass::sampleBSDF
    (BSDFs.h:342-392 and 419-469). All lanes branch-free:

    - entering (wo.y >= 0): 1 -> ior; leaving: ior -> 1 with the local
      frame flipped so the math sees wo.y > 0 (the `sign` trick,
      BSDFs.h:352-361).
    - Fresnel-select reflect vs refract; TIR falls back to reflect.
    Returns (bsdf[R,3], wi[R,3], pdf[R], state)."""
    leaving = wo[..., 1] < 0.0
    ior_o = jnp.where(leaving, ior, 1.0)
    ior_i = jnp.where(leaving, 1.0, ior)
    sign = jnp.where(leaving, -1.0, 1.0)
    lwo = wo * jnp.stack(
        [jnp.ones_like(sign), sign, jnp.ones_like(sign)], axis=-1
    )

    n = jnp.broadcast_to(_UP, wo.shape)
    fr = schlick_fresnel_ior(ior_o, ior_i, lwo, n)

    p, state = cmj_1d(state)

    refl = reflect(-lwo, n)
    ok, trans = refract(lwo, n, ior_o, ior_i)
    if meta:
        # minus-IOR: mirror the transmitted ray across the inverted normal
        trans = trans * jnp.asarray([-1.0, 1.0, -1.0])

    take_reflect = (p < fr) | ~ok
    lwi = jnp.where(take_reflect[..., None], refl, trans)

    pdf = jnp.ones(wo.shape[:-1], jnp.float32)
    absy = jnp.maximum(jnp.abs(lwi[..., 1]), 1e-12)
    bsdf = jnp.broadcast_to(jnp.asarray(rho, jnp.float32), wo.shape) / absy[..., None]

    wi = lwi * jnp.stack(
        [jnp.ones_like(sign), sign, jnp.ones_like(sign)], axis=-1
    )
    return bsdf, wi, pdf, state


def ideal_glass_sample(rho, ior, wo, state: CMJState):
    """reference: BSDFs.h:328-402."""
    return _glass_sample(rho, ior, wo, state, meta=False)


def meta_glass_sample(rho, ior, wo, state: CMJState):
    """reference: BSDFs.h:404-479 (the BSDF facade instantiates THIS one as
    the specular lobe, BSDFs.h:998)."""
    return _glass_sample(rho, ior, wo, state, meta=True)


def glass_eval(wo, wi):
    """Delta lobe: zero everywhere (BSDFs.h:394-396,471-474)."""
    return jnp.zeros(wo.shape, jnp.float32)


def glass_pdf(wo, wi):
    """Delta lobe: zero (BSDFs.h:398-400,476-478)."""
    return jnp.zeros(wo.shape[:-1], jnp.float32)
