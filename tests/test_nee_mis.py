"""NEE/MIS integrator tests (SURVEY.md §7 M3): light sampling properties,
cross-integrator convergence, variance ordering."""

import jax.numpy as jnp
import numpy as np
import pytest

from henjou.runtime.options import RenderOption
from henjou.runtime.renderer import Renderer
from henjou.sampling.cmj import make_cmj_state
from henjou.sampling.light_sample import light_pdf, sample_light
from henjou.scene.scenedata import build_device_scene, build_frame_scene
from henjou.scene.testscenes import cornell_box_scene


def cornell_frame():
    dev = build_device_scene(cornell_box_scene())
    return build_frame_scene(dev)


def test_sample_light_properties():
    frame = cornell_frame()
    n = 4096
    st = make_cmj_state(
        jnp.arange(n, dtype=jnp.uint32) % 64,
        jnp.arange(n, dtype=jnp.uint32),
        seed=2,
    )
    pos, normal, emission, pdf, valid, st2 = sample_light(frame, st)
    pos, normal = np.asarray(pos), np.asarray(normal)
    assert np.asarray(valid).all()
    # positions on the ceiling light quad: y = 1-1e-3, |x|,|z| <= 0.4
    np.testing.assert_allclose(pos[:, 1], 1.0 - 1e-3, atol=1e-5)
    assert np.all(np.abs(pos[:, 0]) <= 0.4 + 1e-5)
    assert np.all(np.abs(pos[:, 2]) <= 0.4 + 1e-5)
    np.testing.assert_allclose(normal[:, 1], -1.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(emission), 10.0, atol=1e-5)
    # pdf: 2 light triangles, each area = 0.5*(0.8*0.8) = 0.32
    np.testing.assert_allclose(np.asarray(pdf), 1.0 / (0.32 * 2), rtol=1e-5)
    # samples cover both triangles
    assert int(st2.depth[0]) == 2  # one 1D + one 2D draw


def test_light_pdf_reverse():
    frame = cornell_frame()
    dev = frame.device
    prim = dev.light_prim_ids.astype(jnp.int32)
    pdfs = np.asarray(light_pdf(frame, prim))
    np.testing.assert_allclose(pdfs, 1.0 / (0.32 * 2), rtol=1e-5)


def _render(integrator, spp, size=24, emission=10.0, seed=0):
    r = Renderer(
        option=RenderOption(
            image_width=size,
            image_height=size,
            max_spp=spp,
            spp_batch=min(spp, 16),
            camera_position=(0.0, 0.0, -4.5),
            camera_direction=(0.0, 0.0, 1.0),
            scene_sky_default=(0.0, 0.0, 0.0),
            seed=seed,
        ),
        integrator=integrator,
    )
    r.set_scene(cornell_box_scene(light_emission=emission))
    r.build()
    return r.render_frame(0)["color"]


@pytest.mark.slow
def test_integrators_converge_to_same_image():
    """PT, NEE and MIS are unbiased estimators of the same transport: their
    low-res Cornell means must agree within MC noise."""
    pt = _render("pathtrace", 512)
    ne = _render("nee", 128)
    mi = _render("mis", 128)
    m_pt, m_ne, m_mi = pt.mean(), ne.mean(), mi.mean()
    assert abs(m_ne - m_pt) / m_pt < 0.08, (m_pt, m_ne)
    assert abs(m_mi - m_pt) / m_pt < 0.08, (m_pt, m_mi)
    # interior region RMSE between NEE and MIS is small at equal spp
    rmse = np.sqrt(((ne[4:-4, 4:-4] - mi[4:-4, 4:-4]) ** 2).mean())
    assert rmse < 0.12, rmse


@pytest.mark.slow
def test_nee_lower_variance_than_pt():
    """With a small area light, NEE's pixel variance is far below PT's at
    equal spp — the reason NEE exists."""
    a = _render("pathtrace", 16, seed=1)
    b = _render("nee", 16, seed=1)
    # exclude the light itself (PT sees it directly, NEE only at depth 0)
    var_pt = np.var(a[12:, :, :])
    var_ne = np.var(b[12:, :, :])
    assert var_ne < var_pt


@pytest.mark.slow
def test_mis_finite_on_gallery():
    """MIS over the full BSDF zoo (specular/metal/thin-film lanes) stays
    finite and non-negative."""
    from henjou.scene.testscenes import sphere_gallery_scene

    r = Renderer(
        option=RenderOption(
            image_width=32,
            image_height=32,
            max_spp=8,
            spp_batch=8,
            camera_position=(0.0, 1.2, -9.0),
            camera_direction=(0.0, -0.05, 1.0),
            scene_sky_default=(0.3, 0.4, 0.55),
        ),
        integrator="mis",
    )
    r.set_scene(sphere_gallery_scene())
    r.build()
    img = r.render_frame(0)["color"]
    assert np.isfinite(img).all()
    assert (img >= 0).all()
    assert img.mean() > 0.05
