"""Light-path scaling (VERDICT r2 ask #6): the chunked dense
intersect_lights must stay exact at >512 lights with flat memory, and
the emissive-subset LBVH (LightAccel) must match it at ~1k mesh lights.

Reference semantics: light_sample.h:9-92 (count-uniform selection) and
the MIS BSDF-branch trace rt.h:382-420."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from henjou.scene.scenedata import SceneData, build_device_scene, build_frame_scene
from henjou.scene.testscenes import _uv_sphere
from henjou.scene.scenedata import make_material


def _many_light_scene(n_panels=550):
    """A floor + n_panels emissive quads (2 tris each -> >1k light tris)."""
    rng = np.random.default_rng(2)
    mats = [
        make_material("floor", base_color=(0.7, 0.7, 0.7), roughness=0.8),
        make_material("light", emission=(5.0, 4.0, 3.0), is_light=True),
    ]
    verts, norms, mids = [], [], []
    s = 10.0
    fv = np.asarray(
        [[-s, -1, -s], [-s, -1, s], [s, -1, s], [-s, -1, -s], [s, -1, s], [s, -1, -s]],
        np.float32,
    )
    fn = np.tile(np.asarray([[0, 1, 0]], np.float32), (6, 1))
    verts.append(fv); norms.append(fn); mids.extend([0, 0])
    for k in range(n_panels):
        c = rng.uniform(-8, 8, 3).astype(np.float32)
        c[1] = rng.uniform(1.0, 6.0)
        w = 0.15
        quad = np.asarray(
            [
                [c[0] - w, c[1], c[2] - w], [c[0] + w, c[1], c[2] - w], [c[0] + w, c[1], c[2] + w],
                [c[0] - w, c[1], c[2] - w], [c[0] + w, c[1], c[2] + w], [c[0] - w, c[1], c[2] + w],
            ],
            np.float32,
        )
        qn = np.tile(np.asarray([[0, -1, 0]], np.float32), (6, 1))
        verts.append(quad); norms.append(qn); mids.extend([1, 1])
    v = np.concatenate(verts)
    return SceneData(
        vertices=v,
        indices=np.arange(len(v), dtype=np.uint32),
        material_ids=np.asarray(mids, np.uint32),
        normals=np.concatenate(norms),
        texcoords=None,
        colors=None,
        materials=mats,
    )


@pytest.fixture(scope="module")
def light_frame():
    scene = _many_light_scene()
    dev = build_device_scene(scene)
    frame = jax.jit(build_frame_scene)(dev, None, None)
    return frame


def test_chunked_intersect_lights_exact_at_1100_lights(light_frame):
    from henjou.sampling.light_sample import intersect_lights

    frame = light_frame
    n_l = int(frame.device.num_lights)
    assert n_l == 1100  # 550 panels x 2 tris

    rng = np.random.default_rng(4)
    n = 2048
    o = jnp.asarray(rng.uniform(-9, 9, (n, 3)).astype(np.float32))
    o = o.at[:, 1].set(-0.5)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 1] = np.abs(d[:, 1]) + 0.2  # look up at the panels
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.asarray(d)

    t, p, u, v, h, area = intersect_lights(frame, o, d, 1e-3, 1e9)
    assert bool(jnp.any(h))

    # oracle: dense MT against all light tris at once (numpy, small n)
    lp = np.asarray(frame.device.light_prim_ids)
    tv = np.asarray(frame.tri_verts)[lp]
    o_n, d_n = np.asarray(o), np.asarray(d)
    v0 = tv[None, :, 0]; e1 = tv[None, :, 1] - tv[None, :, 0]; e2 = tv[None, :, 2] - tv[None, :, 0]
    pv = np.cross(d_n[:, None], e2)
    det = np.sum(e1 * pv, -1)
    inv = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1, det), 0.0)
    tvec = o_n[:, None] - v0
    uu = np.sum(tvec * pv, -1) * inv
    qv = np.cross(tvec, e1)
    vv = np.sum(d_n[:, None] * qv, -1) * inv
    tt = np.sum(e2 * qv, -1) * inv
    ok = (np.abs(det) > 1e-12) & (uu >= 0) & (vv >= 0) & (uu + vv <= 1) & (tt > 1e-3) & (tt < 1e9)
    tt = np.where(ok, tt, np.inf)
    t_ref = tt.min(1)
    h_ref = np.isfinite(t_ref)
    assert (np.asarray(h) == h_ref).all()
    np.testing.assert_allclose(np.asarray(t)[h_ref], t_ref[h_ref], rtol=1e-4)


def test_light_lbvh_matches_dense_at_1100_lights(light_frame):
    """LightAccel (an LBVH over the emissive subset, built by one jitted
    call) traced by the CPU route must give the dense intersect_lights
    answer: same hits, t, global prim ids and light areas."""
    from henjou.sampling.light_sample import (
        build_light_accel,
        intersect_lights,
        make_light_intersector,
    )

    frame = light_frame
    la = jax.jit(build_light_accel)(
        frame.tri_verts, frame.device.light_prim_ids
    )
    assert la.bvh.num_tris == 1100
    lfn = jax.jit(make_light_intersector(la))

    rng = np.random.default_rng(6)
    n = 1024
    o = jnp.asarray(rng.uniform(-9, 9, (n, 3)).astype(np.float32))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.asarray(d)

    t_d, p_d, u_d, v_d, h_d, a_d = intersect_lights(frame, o, d, 1e-3, 1e9)
    t_b, p_b, u_b, v_b, h_b, a_b = lfn(frame, o, d, 1e-3, 1e9)
    hd = np.asarray(h_d)
    assert hd.any()
    assert (hd == np.asarray(h_b)).all()
    np.testing.assert_allclose(np.asarray(t_b)[hd], np.asarray(t_d)[hd], rtol=1e-5)
    assert (np.asarray(p_b)[hd] == np.asarray(p_d)[hd]).all()
    np.testing.assert_allclose(np.asarray(u_b)[hd], np.asarray(u_d)[hd], atol=1e-4)
    np.testing.assert_allclose(np.asarray(a_b)[hd], np.asarray(a_d)[hd], rtol=1e-5)
    assert (np.asarray(p_b)[~hd] == -1).all()


def test_renderer_light_lbvh_matches_dense_path(monkeypatch):
    """Through Renderer (wavefront, reference MIS, >512 emissive tris):
    the LightAccel route renders the same film as the dense
    intersect_lights path it replaces."""
    from henjou.runtime.options import RenderOption
    from henjou.runtime.renderer import Renderer

    def render(threshold):
        monkeypatch.setattr(Renderer, "LIGHT_ACCEL_THRESHOLD", threshold)
        r = Renderer(option=RenderOption(
            image_width=8, image_height=8, max_spp=2, spp_batch=2,
            engine="wavefront", mis_mode="ref", multichip="off",
            camera_position=(0.0, 0.5, -12.0), camera_direction=(0.0, 0.1, 1.0),
        ))
        r.set_scene(_many_light_scene())
        r.build()
        out = r.render_frame(0)
        return out["color"], r._light_accel_cache

    dense, no_accel = render(1 << 30)
    lbvh, accel = render(512)
    assert no_accel is None and accel is not None
    assert np.isfinite(lbvh).all() and lbvh.max() > 0
    np.testing.assert_allclose(lbvh, dense, rtol=1e-4, atol=1e-5)
