"""BSDF facade: per-hit lobe dispatch (reference: BSDFs.h:979-1038).

Routing (BSDFs.h:995-1029):
- ideal_specular        -> MetaMaterialGlass (the minus-IOR glass IS the
                           specular BSDF in the reference facade)
- else metallic > 0.5   -> EnagyConservationGGX (multiple-scattering)
- else                  -> DisneyBRDF
evaluate()/getPDF() route to glass-or-Disney only (BSDFs.h:1006-1037).

Lockstep shape: all lanes compute every lobe's sample from the same input
sampler state, then outputs AND the advanced per-lane sampler state are
selected by category — each lane's random stream advances exactly as if
only its branch had run (consumption parity with the SIMT original).
This is the masked-execution default; wavefront material binning
(sort-by-lobe, SURVEY.md §7 hard part #4) is an optimization hook on top.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

from henjou.bsdf.disney import (
    DisneyParams,
    disney_eval,
    disney_params,
    disney_pdf,
    disney_sample,
)
from henjou.bsdf.glass import glass_eval, glass_pdf, meta_glass_sample
from henjou.bsdf.msggx import msggx_sample
from henjou.sampling.cmj import CMJState


def _params_from_hit(hit) -> DisneyParams:
    return disney_params(
        basecolor=hit.basecolor,
        roughness=hit.roughness,
        metallic=hit.metallic,
        sheen=hit.sheen,
        clearcoat=hit.clearcoat,
        is_thinfilm=hit.is_thinfilm,
    )


def _sel_state(mask, a: CMJState, b: CMJState) -> CMJState:
    return b._replace(depth=jnp.where(mask, a.depth, b.depth))


def bsdf_sample(
    hit,
    local_wo,
    state: CMJState,
    lut: Optional[jnp.ndarray] = None,
    has_specular: bool = True,
    has_metal: bool = True,
    has_sheen: bool = True,
    has_clearcoat: bool = True,
):
    """sampleBSDF dispatch (BSDFs.h:1015-1030).
    Returns (bsdf[R,3], wi[R,3], pdf[R], state).

    has_specular/has_metal are STATIC scene facts (does any material route
    to that lobe?): lockstep lanes pay for every lobe computed, so scenes
    without metals/glass compile without those branches entirely."""
    p = _params_from_hit(hit)
    b_dis, wi_dis, pdf_dis, st_dis = disney_sample(
        p, local_wo, state, lut, has_sheen, has_clearcoat
    )
    bsdf, wi, pdf, st = b_dis, wi_dis, pdf_dis, st_dis

    if has_metal:
        is_ggx = hit.metallic > 0.5  # BSDFs.h:1003
        b_ms, wi_ms, pdf_ms, st_ms = msggx_sample(
            hit.basecolor, hit.roughness, local_wo, state
        )
        ggx = is_ggx[..., None]
        bsdf = jnp.where(ggx, b_ms, bsdf)
        wi = jnp.where(ggx, wi_ms, wi)
        pdf = jnp.where(is_ggx, pdf_ms, pdf)
        st = _sel_state(is_ggx, st_ms, st)

    if has_specular:
        is_spec = hit.is_specular
        b_glass, wi_glass, pdf_glass, st_glass = meta_glass_sample(
            jnp.ones_like(hit.basecolor), hit.ior, local_wo, state
        )
        spec = is_spec[..., None]
        bsdf = jnp.where(spec, b_glass, bsdf)
        wi = jnp.where(spec, wi_glass, wi)
        pdf = jnp.where(is_spec, pdf_glass, pdf)
        st = _sel_state(is_spec, st_glass, st)

    return bsdf, wi, pdf, st


def bsdf_eval(
    hit,
    local_wo,
    local_wi,
    lut: Optional[jnp.ndarray] = None,
    has_sheen: bool = True,
    has_clearcoat: bool = True,
):
    """evaluateBSDF dispatch (BSDFs.h:1006-1013): glass lanes are delta
    (0), everything else evaluates Disney — including metals, exactly as
    the reference does for NEE."""
    p = _params_from_hit(hit)
    val = disney_eval(p, local_wo, local_wi, lut, has_sheen, has_clearcoat)
    return jnp.where(hit.is_specular[..., None], glass_eval(local_wo, local_wi), val)


def bsdf_pdf(hit, local_wo, local_wi):
    """getPDF dispatch (BSDFs.h:1032-1037)."""
    p = _params_from_hit(hit)
    val = disney_pdf(p, local_wo, local_wi)
    return jnp.where(hit.is_specular, glass_pdf(local_wo, local_wi), val)


def make_bsdf_sampler(
    lut: Optional[jnp.ndarray] = None,
    has_specular: bool = True,
    has_metal: bool = True,
    has_sheen: bool = True,
    has_clearcoat: bool = True,
):
    """Closure matching the integrator's bsdf_sample signature."""

    def sampler(hit, local_wo, state):
        return bsdf_sample(
            hit, local_wo, state, lut,
            has_specular=has_specular, has_metal=has_metal,
            has_sheen=has_sheen, has_clearcoat=has_clearcoat,
        )

    return sampler
