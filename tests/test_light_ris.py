"""RIS/WRS next-event light sampling (sampling/light_sample.py
sample_light_ris; options.py Henjou.light_ris).

The reference draws exactly one uniform light candidate
(light_sample.h:40); RIS draws m from the same base strategy, weights
by unshadowed geometric contribution at the shading point, keeps one.
Unbiasedness here is checked by the two defining RIS identities:
E[phi(X_k)/pdf_eff * 1] = integral(phi) for any integrand covered by
the target's support, and end-to-end by a wavefront MIS render parity
against the plain one-candidate estimator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from henjou.sampling import light_sample as ls
from henjou.sampling.cmj import make_cmj_state
from henjou.scene.scenedata import build_device_scene, build_frame_scene

from test_light_power import _two_light_scene  # tests/ is on sys.path under pytest

_LUM = np.asarray([0.2126, 0.7152, 0.0722], np.float32)


def _frame():
    return build_frame_scene(build_device_scene(_two_light_scene(8.0, 1.0)))


def _shade_point(n_lanes):
    # off-plane of both light panels (ceiling y=+1, back wall z=+1) so
    # no candidate's |cos| terms vanish
    pos = jnp.broadcast_to(
        jnp.asarray([0.1, -0.3, -0.2], jnp.float32), (n_lanes, 3)
    )
    nrm = jnp.broadcast_to(
        jnp.asarray([0.0, 1.0, 0.0], jnp.float32), (n_lanes, 3)
    )
    return pos, nrm


def _state(n, seed):
    return make_cmj_state(
        jnp.arange(n, dtype=jnp.uint32) % 977,
        jnp.arange(n, dtype=jnp.uint32),
        seed=seed,
    )


def _total_light_area(frame):
    tv = np.asarray(frame.tri_verts)[np.asarray(frame.device.light_prim_ids)]
    return float(
        0.5
        * np.linalg.norm(
            np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]), axis=1
        ).sum()
    )


def test_ris_pdf_eff_integrates_area():
    """E[1/pdf_eff] over the RIS draw equals total light area — the same
    identity the plain sampler satisfies. Checks the full resampling
    chain: candidate pdfs, target weights, cdf pick, and the
    p_hat_k * m / sum(w) effective density."""
    frame = _frame()
    n = 1 << 15
    pos, nrm = _shade_point(n)
    area = _total_light_area(frame)

    for m in (2, 4):
        _, _, _, pdf_eff, _, valid, _ = jax.jit(
            lambda st: ls.sample_light_ris(frame, st, pos, nrm, m),
            static_argnums=(),
        )(_state(n, seed=7 + m))
        est = np.where(
            np.asarray(valid), 1.0 / np.maximum(np.asarray(pdf_eff), 1e-30), 0.0
        )
        np.testing.assert_allclose(est.mean(), area, rtol=0.05), m

    # plain sampler satisfies the same identity (sanity anchor)
    _, _, _, pdf, valid, _ = ls.sample_light(frame, _state(n, seed=3))
    est0 = np.where(
        np.asarray(valid), 1.0 / np.maximum(np.asarray(pdf), 1e-30), 0.0
    )
    np.testing.assert_allclose(est0.mean(), area, rtol=0.05)


def test_ris_matches_plain_mean_with_lower_variance():
    """Estimating the unshadowed direct-light integral (the target
    function itself): RIS and plain one-candidate sampling agree in the
    mean, and the RIS per-sample variance is far lower — with the
    integrand equal to the target, each RIS sample's value collapses to
    the mean of its m candidate weights."""
    frame = _frame()
    n = 1 << 15
    pos, nrm = _shade_point(n)
    p0 = np.asarray(pos[0])
    n0 = np.asarray(nrm[0])

    def phat(lpos, lnrm, lemi):
        to_l = np.asarray(lpos) - p0
        d2 = np.maximum((to_l * to_l).sum(-1), 1e-12)
        ldir = to_l / np.sqrt(d2)[:, None]
        cos1 = np.abs((ldir * n0).sum(-1))
        cos2 = np.abs((-ldir * np.asarray(lnrm)).sum(-1))
        lum = np.asarray(lemi) @ _LUM
        return lum * cos1 * cos2 / d2

    lp, ln, le, pdf, valid, _ = ls.sample_light(frame, _state(n, seed=11))
    v_plain = phat(lp, ln, le) / np.maximum(np.asarray(pdf), 1e-30)

    lp, ln, le, pdf_eff, _, valid_r, _ = ls.sample_light_ris(
        frame, _state(n, seed=12), pos, nrm, 4
    )
    v_ris = np.where(
        np.asarray(valid_r),
        phat(lp, ln, le) / np.maximum(np.asarray(pdf_eff), 1e-30),
        0.0,
    )

    np.testing.assert_allclose(v_ris.mean(), v_plain.mean(), rtol=0.05)
    assert v_ris.var() < 0.5 * v_plain.var(), (v_ris.var(), v_plain.var())


@pytest.mark.slow
def test_wavefront_ris_render_unbiased():
    """End-to-end: a wavefront MIS render with light_ris=4 agrees in the
    mean with the plain estimator on the two-light Cornell (RIS changes
    the sampler stream, so agreement is statistical, averaged over
    seeds), and its seed-to-seed pixel variance does not regress."""
    from henjou.bsdf.dispatch import bsdf_eval, bsdf_pdf, make_bsdf_sampler
    from henjou.integrator.payload import Sky
    from henjou.integrator.wavefront import wavefront_render
    from henjou.runtime.camera import make_camera

    frame = _frame()
    sky = Sky(constant_color=jnp.zeros(3), intensity=jnp.asarray(0.0))
    cam = make_camera((0.0, 0.0, -0.95), (0.0, 0.0, 1.0), np.pi / 3)
    w = h = 16
    spp = 64
    bsdf_sample = make_bsdf_sampler(None)

    def render(seed, ris):
        film = jax.jit(
            lambda: wavefront_render(
                frame, sky, cam, w, h, spp, bsdf_sample,
                bsdf_eval=bsdf_eval, bsdf_pdf=bsdf_pdf,
                integrator="mis", seed=seed, lanes=1024,
                mis_single=True, light_ris=ris,
            )
        )()
        return np.asarray(film.color) / spp

    seeds = (0, 1, 2, 3)
    plain = np.stack([render(s, 0) for s in seeds])
    ris = np.stack([render(s, 4) for s in seeds])

    # unbiased: seed-averaged images agree
    scale = plain.mean()
    assert abs(ris.mean() - plain.mean()) / scale < 0.02, (
        ris.mean(), plain.mean()
    )
    # variance across seeds must not regress (>= parity; the win grows
    # with light count/contrast — this 3-panel scene is a floor test)
    v_plain = plain.var(axis=0).mean()
    v_ris = ris.var(axis=0).mean()
    assert v_ris < 1.3 * v_plain, (v_ris, v_plain)
