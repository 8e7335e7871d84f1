"""Power-weighted light selection (luminance x area importance sampling).

The reference selects uniformly over the emissive list
(light_sample.h:40); henjou defaults to power weighting with all
pdfs (forward + MIS reverse) adjusted, so the estimator stays unbiased
— verified here by comparing converged MIS renders under both modes —
while variance drops when lights differ in brightness.
HENJOU_LIGHT_SAMPLING=uniform restores exact reference selection.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from henjou.scene.scenedata import build_device_scene, build_frame_scene
from henjou.scene.testscenes import (
    SceneData,
    cornell_box_scene,
)
from henjou.sampling.cmj import make_cmj_state


def _two_light_scene(bright=80.0, dim=1.0):
    """Cornell variant with a second, larger, much dimmer light panel on
    the floor: weights must concentrate selection on the bright panel."""
    from henjou.scene.testscenes import _quad, _build_tri_soup
    from henjou.scene.scenedata import make_material, GeometryData

    white = make_material("white", base_color=(0.8, 0.8, 0.8), roughness=1.0)
    l_hi = make_material(
        "bright", base_color=(1, 1, 1), emission=(bright,) * 3, is_light=True
    )
    l_lo = make_material(
        "dim", base_color=(1, 1, 1), emission=(dim,) * 3, is_light=True
    )
    s = 1.0
    tris = []
    tris.append((_quad([-s, -s, -s], [-s, -s, s], [s, -s, s], [s, -s, -s]), 0))
    tris.append((_quad([-s, s, -s], [s, s, -s], [s, s, s], [-s, s, s]), 0))
    tris.append((_quad([-s, -s, s], [-s, s, s], [s, s, s], [s, -s, s]), 0))
    # small bright ceiling panel
    l = 0.2
    y = s - 1e-3
    tris.append((_quad([-l, y, -l], [l, y, -l], [l, y, l], [-l, y, l]), 1))
    # big dim panel low on the back wall
    b = 0.8
    z = s - 1e-3
    tris.append((_quad([-b, -0.9, z], [-b, 0.1, z], [b, 0.1, z], [b, -0.9, z]), 2))
    verts, norms, indices, mat_ids = _build_tri_soup(tris)
    return SceneData(
        vertices=verts,
        indices=indices,
        material_ids=mat_ids,
        normals=norms,
        texcoords=None,
        colors=None,
        materials=[white, l_hi, l_lo],
        geometries=[GeometryData(0, len(indices))],
    )


def _frame(scene):
    return build_frame_scene(build_device_scene(scene))


def test_power_weights_match_luminance_area():
    """Empirical selection frequency tracks lum*area; forward pdf is
    p_i/area_i (verified against the sampled panel's position)."""
    from henjou.sampling import light_sample as ls

    assert ls.LIGHT_SAMPLING == "power"  # default
    frame = _frame(_two_light_scene(bright=80.0, dim=1.0))
    dev = frame.device
    tv = np.asarray(frame.tri_verts)[np.asarray(dev.light_prim_ids)]
    area = 0.5 * np.linalg.norm(
        np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]), axis=1
    )
    lum = np.asarray(dev.light_prim_emission) @ np.asarray([0.2126, 0.7152, 0.0722])
    w_ref = lum * area
    w_ref /= w_ref.sum()

    n = 1 << 14
    st = make_cmj_state(
        jnp.arange(n, dtype=jnp.uint32) % 512,
        jnp.arange(n, dtype=jnp.uint32),
        seed=5,
    )
    pos, normal, emission, pdf, valid, _ = ls.sample_light(frame, st)
    pos = np.asarray(pos)
    on_ceiling = pos[:, 1] > 0.5
    frac_bright = on_ceiling.mean()
    w_bright = w_ref[: 2].sum()  # first two tris = ceiling panel
    assert abs(frac_bright - w_bright) < 0.02, (frac_bright, w_bright)
    # pdf on ceiling lanes = p_tri/area_tri (two equal tris per panel)
    pdf = np.asarray(pdf)
    expect_ceiling = (w_ref[0] / area[0])
    np.testing.assert_allclose(pdf[on_ceiling], expect_ceiling, rtol=1e-4)


def test_reverse_pdf_table_consistent():
    """light_pdf == selection prob / area on light prims, 0 on others."""
    from henjou.sampling.light_sample import (
        light_pdf,
        light_selection_prob_by_prim,
    )

    frame = _frame(_two_light_scene())
    dev = frame.device
    lp = np.asarray(dev.light_prim_ids)
    tbl = np.asarray(light_selection_prob_by_prim(frame))
    assert tbl.sum() == pytest.approx(1.0, abs=1e-5)
    assert (tbl[lp] > 0).all()
    non_light = np.setdiff1d(np.arange(frame.tri_verts.shape[0]), lp)
    assert (tbl[non_light] == 0).all()
    pdfs = np.asarray(light_pdf(frame, jnp.asarray(lp.astype(np.int32))))
    tv = np.asarray(frame.tri_verts)[lp]
    area = 0.5 * np.linalg.norm(
        np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]), axis=1
    )
    np.testing.assert_allclose(pdfs, tbl[lp] / area, rtol=1e-5)


@pytest.mark.slow
def test_power_unbiased_and_lower_variance(monkeypatch):
    """MIS renders of the two-light scene: power and uniform selection
    agree in the mean (unbiased) and power has lower pixel variance
    across independent seeds."""
    from henjou.integrator.mis import mis
    from henjou.runtime.camera import make_camera
    from henjou.integrator.payload import Sky
    from henjou.sampling import light_sample as ls

    frame = _frame(_two_light_scene(bright=80.0, dim=1.0))
    cam = make_camera((0.0, 0.0, -0.95), (0.0, 0.0, 1.0), np.pi / 3)
    sky = Sky(constant_color=jnp.zeros(3), intensity=jnp.asarray(0.0))

    size = 16

    from henjou.runtime.camera import camera_rays

    def make_render(mode):
        monkeypatch.setattr(ls, "LIGHT_SAMPLING", mode)
        jax.clear_caches()  # mode is baked into traces

        @jax.jit
        def one_spp(frame, s):
            n = size * size
            pix = jnp.arange(n, dtype=jnp.uint32)
            st = make_cmj_state(jnp.full((n,), s, jnp.uint32), pix, seed=0)
            o, d, st = camera_rays(cam, size, size, pix, st)
            return mis(frame, sky, o, d, st).lte

        def render(seed, spp):
            acc = jnp.zeros((size * size, 3))
            for s in range(spp):
                acc = acc + one_spp(frame, jnp.uint32(s + spp * seed))
            return np.asarray(acc / spp)

        return render

    means = {}
    samples = {}
    for mode in ("power", "uniform"):
        render = make_render(mode)
        imgs = [render(seed, spp=24) for seed in (1, 2, 3)]
        samples[mode] = imgs
        means[mode] = np.mean(imgs, axis=0)

    # unbiased: the two converged means agree (loose tol at 72 spp total)
    bright = means["uniform"].mean()
    assert abs(means["power"].mean() - bright) / bright < 0.08, (
        means["power"].mean(), bright
    )
    var_p = np.var(np.stack(samples["power"]), axis=0).mean()
    var_u = np.var(np.stack(samples["uniform"]), axis=0).mean()
    assert var_p < var_u, (var_p, var_u)
