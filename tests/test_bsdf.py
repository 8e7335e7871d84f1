"""BSDF library tests (SURVEY.md §7 M2): per-lobe furnace / consistency /
direction checks, mirroring the reference's WhiteFurnanceTest scenes."""

import jax.numpy as jnp
import numpy as np
import pytest

from henjou.bsdf.disney import disney_eval, disney_params, disney_pdf, disney_sample
from henjou.bsdf.ggx import ggx_eval, ggx_sample
from henjou.bsdf.glass import ideal_glass_sample, meta_glass_sample
from henjou.bsdf.msggx import msggx_sample
from henjou.math.vec import normalize
from henjou.sampling.cmj import make_cmj_state


def states(n, seed=0):
    return make_cmj_state(
        jnp.arange(n, dtype=jnp.uint32) % 1024,
        jnp.arange(n, dtype=jnp.uint32) // 1024,
        seed=seed,
    )


def tile_wo(vec, n):
    v = np.asarray(vec, np.float32)
    v = v / np.linalg.norm(v)
    return jnp.asarray(np.tile(v, (n, 1)))


N = 1 << 16


# ---------------- GGX ----------------


def test_ggx_sample_eval_pdf_consistency():
    """Importance-sampled E[f*cos/pdf] must match a uniform-hemisphere MC
    integral of eval (sampler, pdf, and eval mutually consistent), and the
    directional albedo must stay <= 1. Single-scatter GGX famously loses
    energy at high roughness (~0.32 at alpha=1 here) — which is exactly why
    the reference adds EnagyConservationGGX."""
    for rough in (0.5, 1.0):
        wo = tile_wo([0.3, 0.8, 0.1], N)
        f0 = jnp.ones((N, 3))
        bsdf, wi, pdf, _ = ggx_sample(f0, jnp.full((N,), rough), wo, states(N))
        est = (
            np.asarray(bsdf) * np.abs(np.asarray(wi)[:, 1:2]) / np.asarray(pdf)[:, None]
        ).mean(axis=0)
        assert np.all(est <= 1.0 + 5e-2), (rough, est)

        rng = np.random.default_rng(42)
        u = rng.uniform(size=N).astype(np.float32)
        phi = rng.uniform(0, 2 * np.pi, size=N).astype(np.float32)
        st = np.sqrt(1 - u * u)
        wi_u = jnp.asarray(np.stack([st * np.cos(phi), u, st * np.sin(phi)], axis=-1))
        f_u = np.asarray(ggx_eval(f0, jnp.full((N,), rough), wo, wi_u))
        est_u = (f_u * u[:, None] * 2 * np.pi).mean(axis=0)
        np.testing.assert_allclose(est, est_u, rtol=0.05, atol=0.01)

    # near-mirror case: VNDF sampling is essentially lossless
    wo = tile_wo([0.3, 0.8, 0.1], N)
    f0 = jnp.ones((N, 3))
    bsdf, wi, pdf, _ = ggx_sample(f0, jnp.full((N,), 0.1), wo, states(N))
    est = (
        np.asarray(bsdf) * np.abs(np.asarray(wi)[:, 1:2]) / np.asarray(pdf)[:, None]
    ).mean(axis=0)
    assert np.all(est >= 0.93) and np.all(est <= 1.001)


def test_ggx_reflect_above_surface():
    wo = tile_wo([0.5, 0.7, 0.2], 4096)
    bsdf, wi, pdf, _ = ggx_sample(
        jnp.ones((4096, 3)), jnp.full((4096,), 0.3), wo, states(4096)
    )
    wi = np.asarray(wi)
    below = wi[:, 1] <= 0
    # below-horizon samples are zeroed (BSDFs.h:113-116)
    assert np.all(np.asarray(bsdf)[below] == 0.0)
    np.testing.assert_allclose(np.linalg.norm(wi, axis=-1), 1.0, atol=1e-4)


# ---------------- multiple-scattering GGX ----------------


def test_msggx_white_furnace():
    """THE energy-conservation test: F0=1 multiple-scattering GGX at high
    roughness returns ~all energy (walk capped at 5 orders loses a bit)."""
    for rough, lo in [(0.3, 0.97), (1.0, 0.90)]:
        wo = tile_wo([0.0, 1.0, 0.0], N)
        bsdf, wi, pdf, _ = msggx_sample(
            jnp.ones((N, 3)), jnp.full((N,), rough), wo, states(N, seed=3)
        )
        # estimator: bsdf * |wi.y| / pdf with pdf = |wi.y| -> weight itself
        est = np.asarray(bsdf) * np.abs(np.asarray(wi)[:, 1:2]) / np.asarray(pdf)[:, None]
        albedo = est.mean(axis=0)
        assert np.all(albedo <= 1.0 + 1e-3), (rough, albedo)
        assert np.all(albedo >= lo), (rough, albedo)


def test_msggx_beats_single_scatter():
    """Multiple scattering must return MORE energy than single-scatter GGX
    at roughness 1 (that's its reason to exist)."""
    wo = tile_wo([0.2, 0.9, 0.0], N)
    f0 = jnp.ones((N, 3))
    rough = jnp.full((N,), 1.0)
    b1, wi1, p1, _ = ggx_sample(f0, rough, wo, states(N, seed=5))
    b2, wi2, p2, _ = msggx_sample(f0, rough, wo, states(N, seed=5))
    a1 = (np.asarray(b1) * np.abs(np.asarray(wi1)[:, 1:2]) / np.asarray(p1)[:, None]).mean()
    a2 = (np.asarray(b2) * np.abs(np.asarray(wi2)[:, 1:2]) / np.asarray(p2)[:, None]).mean()
    assert a2 > a1 + 0.05


def test_msggx_directions_unit_and_upper():
    wo = tile_wo([0.4, 0.8, -0.2], 8192)
    bsdf, wi, pdf, st = msggx_sample(
        jnp.full((8192, 3), 0.8), jnp.full((8192,), 0.5), wo, states(8192, seed=7)
    )
    wi = np.asarray(wi)
    live = np.asarray(bsdf).sum(axis=-1) > 0
    np.testing.assert_allclose(
        np.linalg.norm(wi[live], axis=-1), 1.0, atol=1e-3
    )
    assert np.all(wi[live, 1] > 0.0)
    assert np.isfinite(np.asarray(bsdf)).all()
    assert np.isfinite(np.asarray(pdf)).all()


# ---------------- glass / meta-glass ----------------


def test_ideal_glass_fresnel_split_and_snell():
    n = 1 << 15
    wo = tile_wo([0.0, 1.0, 0.0], n)  # normal incidence
    bsdf, wi, pdf, _ = ideal_glass_sample(
        jnp.ones((n, 3)), jnp.full((n,), 1.5), wo, states(n, seed=9)
    )
    wi = np.asarray(wi)
    reflected = wi[:, 1] > 0
    frac = reflected.mean()
    # F0 at normal incidence for ior 1.5 = 0.04
    assert abs(frac - 0.04) < 0.01
    # transmitted rays continue straight down at normal incidence
    trans = wi[~reflected]
    np.testing.assert_allclose(trans[:, 1], -1.0, atol=1e-5)


def test_ideal_glass_snell_angle():
    n = 1 << 15
    wo = tile_wo([np.sin(0.6), np.cos(0.6), 0.0], n)
    _, wi, _, _ = ideal_glass_sample(
        jnp.ones((n, 3)), jnp.full((n,), 1.5), wo, states(n, seed=11)
    )
    wi = np.asarray(wi)
    trans = wi[wi[:, 1] < 0]
    sin_t = np.abs(trans[:, 0])
    np.testing.assert_allclose(sin_t, np.sin(0.6) / 1.5, atol=1e-4)


def test_meta_glass_flips_transmission():
    """Minus-IOR check (BSDFs.h:453-455): meta transmission is the
    horizontal mirror of ideal transmission."""
    n = 1 << 14
    wo = tile_wo([np.sin(0.5), np.cos(0.5), 0.2], n)
    wo = normalize(wo)
    _, wi_i, _, _ = ideal_glass_sample(
        jnp.ones((n, 3)), jnp.full((n,), 1.5), wo, states(n, seed=13)
    )
    _, wi_m, _, _ = meta_glass_sample(
        jnp.ones((n, 3)), jnp.full((n,), 1.5), wo, states(n, seed=13)
    )
    wi_i, wi_m = np.asarray(wi_i), np.asarray(wi_m)
    trans = wi_i[:, 1] < 0
    assert trans.any()
    np.testing.assert_allclose(wi_m[trans, 0], -wi_i[trans, 0], atol=1e-6)
    np.testing.assert_allclose(wi_m[trans, 1], wi_i[trans, 1], atol=1e-6)
    np.testing.assert_allclose(wi_m[trans, 2], -wi_i[trans, 2], atol=1e-6)
    # reflection branch is identical
    refl = wi_i[:, 1] > 0
    np.testing.assert_allclose(wi_m[refl], wi_i[refl], atol=1e-6)


def test_glass_tir_from_inside():
    n = 4096
    # grazing from inside (wo.y < 0 means inside per the sign convention)
    wo = tile_wo([0.95, -0.31, 0.0], n)
    wo = normalize(wo)
    _, wi, _, _ = ideal_glass_sample(
        jnp.ones((n, 3)), jnp.full((n,), 1.5), wo, states(n, seed=15)
    )
    # beyond critical angle: everything reflects back inside (wi.y < 0)
    assert np.all(np.asarray(wi)[:, 1] < 0)


def test_glass_energy_conservation():
    """bsdf * |cos| / pdf == rho for every glass sample (perfect white)."""
    n = 8192
    wo = normalize(tile_wo([0.3, 0.9, -0.1], n))
    bsdf, wi, pdf, _ = ideal_glass_sample(
        jnp.ones((n, 3)), jnp.full((n,), 1.5), wo, states(n, seed=17)
    )
    est = np.asarray(bsdf) * np.abs(np.asarray(wi)[:, 1:2]) / np.asarray(pdf)[:, None]
    np.testing.assert_allclose(est, 1.0, atol=1e-4)


# ---------------- Disney ----------------


def disney_p(n, **kw):
    args = dict(
        basecolor=jnp.full((n, 3), kw.pop("basecolor", 0.8)),
        roughness=jnp.full((n,), kw.pop("roughness", 0.5)),
        metallic=jnp.full((n,), kw.pop("metallic", 0.0)),
        sheen=jnp.full((n,), kw.pop("sheen", 0.0)),
        clearcoat=jnp.full((n,), kw.pop("clearcoat", 0.0)),
    )
    return disney_params(**args)


def test_disney_eval_nonnegative_reciprocal_shape():
    p = disney_p(1024, roughness=0.4)
    rng = np.random.default_rng(1)
    wo = normalize(jnp.asarray(np.abs(rng.normal(size=(1024, 3))).astype(np.float32)))
    wi = normalize(jnp.asarray(np.abs(rng.normal(size=(1024, 3))).astype(np.float32)))
    f = np.asarray(disney_eval(p, wo, wi))
    assert f.shape == (1024, 3)
    assert np.all(f >= 0.0)
    assert np.isfinite(f).all()


@pytest.mark.parametrize(
    "rough,metal", [(0.8, 0.0), (0.3, 0.0), (0.5, 0.4), (0.2, 0.9)]
)
def test_disney_sample_matches_uniform_integral(rough, metal):
    """Importance-sampled integral of f*cos vs a uniform-hemisphere MC
    integral of eval: both estimate directional albedo."""
    n = N
    p = disney_p(n, roughness=rough, metallic=metal)
    wo = tile_wo([0.25, 0.9, 0.1], n)

    bsdf, wi, pdf, _ = disney_sample(p, wo, states(n, seed=19))
    est_is = (
        np.asarray(bsdf) * np.abs(np.asarray(wi)[:, 1:2]) / np.asarray(pdf)[:, None]
    ).mean(axis=0)

    rng = np.random.default_rng(2)
    u = rng.uniform(size=n).astype(np.float32)
    phi = rng.uniform(0, 2 * np.pi, size=n).astype(np.float32)
    st = np.sqrt(1 - u * u)
    wi_u = jnp.asarray(
        np.stack([st * np.cos(phi), u, st * np.sin(phi)], axis=-1)
    )
    f_u = np.asarray(disney_eval(p, wo, wi_u))
    est_uniform = (f_u * u[:, None] * (2 * np.pi)).mean(axis=0)

    np.testing.assert_allclose(est_is, est_uniform, rtol=0.08, atol=0.02)


def test_disney_pdf_integrates_to_one():
    """MIS pdf (diffuse+specular mixture) integrates to ~1 over the
    hemisphere."""
    n = N
    p = disney_p(n, roughness=0.5, metallic=0.3)
    wo = tile_wo([0.3, 0.85, 0.0], n)
    rng = np.random.default_rng(3)
    u = rng.uniform(size=n).astype(np.float32)
    phi = rng.uniform(0, 2 * np.pi, size=n).astype(np.float32)
    st = np.sqrt(1 - u * u)
    wi_u = jnp.asarray(np.stack([st * np.cos(phi), u, st * np.sin(phi)], axis=-1))
    pdfs = np.asarray(disney_pdf(p, wo, wi_u))
    integral = (pdfs * 2 * np.pi).mean()
    np.testing.assert_allclose(integral, 1.0, atol=0.06)


def test_disney_thinfilm_lut_changes_specular():
    from henjou.texture.lut import default_lut

    lut = default_lut()
    n = 4096
    base = disney_p(n, roughness=0.2)
    film = base._replace(is_thinfilm=jnp.ones((n,), jnp.bool_))
    wo = tile_wo([0.2, 0.9, 0.0], n)
    wi = tile_wo([-0.2, 0.9, 0.0], n)
    f_plain = np.asarray(disney_eval(base, wo, wi, lut))
    f_film = np.asarray(disney_eval(film, wo, wi, lut))
    assert not np.allclose(f_plain, f_film)
    # thin-film F0 is chromatic: channels differ
    assert np.std(f_film.mean(axis=0)) > 1e-5


# ---------------- dispatch ----------------


def test_dispatch_routing():
    from henjou.bsdf.dispatch import bsdf_sample
    from henjou.integrator.payload import SurfaceHit

    n = 3
    mk = lambda shape, val: jnp.full(shape, val)
    hit = SurfaceHit(
        is_hit=jnp.ones((n,), jnp.bool_),
        t=mk((n,), 1.0),
        position=jnp.zeros((n, 3)),
        normal=jnp.asarray([[0.0, 1.0, 0.0]] * n),
        vert_color=jnp.ones((n, 3)),
        texcoord=jnp.zeros((n, 2)),
        material_id=jnp.zeros((n,), jnp.int32),
        basecolor=jnp.full((n, 3), 0.9),
        metallic=jnp.asarray([0.0, 1.0, 0.0]),  # lane1 -> msggx
        roughness=mk((n,), 0.4),
        subsurface=mk((n,), 0.0),
        sheen=mk((n,), 0.0),
        clearcoat=mk((n,), 0.0),
        ior=mk((n,), 1.5),
        transmission=mk((n,), 0.0),
        is_specular=jnp.asarray([False, False, True]),  # lane2 -> glass
        emission=jnp.zeros((n, 3)),
        is_light=jnp.zeros((n,), jnp.bool_),
        is_thinfilm=jnp.zeros((n,), jnp.bool_),
        primitive_id=jnp.zeros((n,), jnp.int32),
        instance_id=jnp.zeros((n,), jnp.int32),
    )
    wo = normalize(jnp.asarray([[0.3, 0.9, 0.0]] * n))
    st = states(n, seed=21)
    bsdf, wi, pdf, st2 = bsdf_sample(hit, wo, st)
    assert np.isfinite(np.asarray(bsdf)).all()
    assert np.isfinite(np.asarray(wi)).all()
    assert np.isfinite(np.asarray(pdf)).all()
    # glass lane: pdf == 1 (delta), direction not necessarily upper
    np.testing.assert_allclose(float(pdf[2]), 1.0)
    # per-lane stream consumption differs by lobe:
    d = np.asarray(st2.depth)
    assert d[2] == 1  # glass: one 1D draw
    assert d[0] == 2  # disney: 1D select + 2D
    assert d[1] >= 2  # msggx walk: at least height+phase draws
