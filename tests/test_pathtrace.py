"""End-to-end integrator tests on built-in scenes (SURVEY.md §7 M1)."""

import jax.numpy as jnp
import numpy as np
import pytest

from henjou.integrator.payload import Sky, closest_hit
from henjou.integrator.pathtrace import pathtrace
from henjou.runtime.camera import camera_rays, make_camera
from henjou.runtime.options import RenderOption
from henjou.runtime.renderer import Renderer
from henjou.sampling.cmj import make_cmj_state
from henjou.scene.scenedata import build_device_scene, build_frame_scene
from henjou.scene.testscenes import cornell_box_scene, furnace_scene


def black_sky():
    return Sky(
        constant_color=jnp.zeros(3), intensity=jnp.asarray(1.0), use_ibl=False
    )


def white_sky(v=1.0):
    return Sky(
        constant_color=jnp.full((3,), v), intensity=jnp.asarray(1.0), use_ibl=False
    )


def test_closest_hit_payload_cornell():
    dev = build_device_scene(cornell_box_scene())
    frame = build_frame_scene(dev)
    # ray at the box center looking at the red left wall
    o = jnp.asarray([[0.0, 0.0, 0.0]])
    d = jnp.asarray([[-1.0, 0.0, 0.0]])
    hit = closest_hit(frame, black_sky(), o, d)
    assert bool(hit.is_hit[0])
    np.testing.assert_allclose(float(hit.t[0]), 1.0, atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(hit.basecolor[0]), [0.8, 0.05, 0.05], atol=1e-6
    )
    np.testing.assert_allclose(np.asarray(hit.normal[0]), [1.0, 0.0, 0.0], atol=1e-5)
    # up at the light
    d = jnp.asarray([[0.0, 1.0, 0.0]])
    hit = closest_hit(frame, black_sky(), o, d)
    assert bool(hit.is_light[0])
    assert float(hit.emission[0, 0]) > 1.0


def test_miss_returns_sky():
    dev = build_device_scene(furnace_scene())
    frame = build_frame_scene(dev)
    o = jnp.asarray([[0.0, 0.0, -5.0]])
    d = jnp.asarray([[0.0, 1.0, 0.0]])
    hit = closest_hit(frame, white_sky(0.5), o, d)
    assert not bool(hit.is_hit[0])
    np.testing.assert_allclose(np.asarray(hit.emission[0]), 0.5, atol=1e-6)


def test_lambert_furnace():
    """White furnace: albedo-1 Lambert sphere in a uniform sky of radiance L
    must render exactly L everywhere (energy conservation through the
    10-bounce loop + RR)."""
    dev = build_device_scene(furnace_scene(albedo=1.0))
    frame = build_frame_scene(dev)
    n = 2048
    state = make_cmj_state(
        jnp.arange(n, dtype=jnp.uint32) % 64, jnp.arange(n, dtype=jnp.uint32), seed=1
    )
    # rays that hit the unit sphere from z=-3
    rng = np.random.default_rng(0)
    px = rng.uniform(-0.25, 0.25, size=(n, 2)).astype(np.float32)
    o = jnp.asarray(np.concatenate([px * 0, np.full((n, 1), -3.0)], axis=-1))
    o = o.at[:, :2].set(jnp.asarray(px * 0.8))
    d = jnp.asarray(np.tile([0.0, 0.0, 1.0], (n, 1)).astype(np.float32))
    res = pathtrace(frame, white_sky(1.0), o, d, state)
    mean = np.asarray(res.lte).mean(axis=0)
    # unbiased estimator of 1.0 (most paths escape within 10 bounces;
    # depth-10 truncation loses a tiny amount of energy)
    np.testing.assert_allclose(mean, 1.0, atol=0.03)


@pytest.mark.slow
def test_cornell_render_statistics():
    """Low-spp Cornell render sanity: light pixels ~emission, energy
    bounded, red/green bleed present on the correct sides."""
    r = Renderer(
        option=RenderOption(
            image_width=64,
            image_height=64,
            max_spp=32,
            spp_batch=8,
            camera_position=(0.0, 0.0, -4.5),
            camera_direction=(0.0, 0.0, 1.0),
            scene_sky_default=(0.0, 0.0, 0.0),
        )
    )
    r.set_scene(cornell_box_scene(light_emission=10.0))
    r.build()
    aovs = r.render_frame(0)
    img = aovs["color"]
    assert img.shape == (64, 64, 3)
    assert np.isfinite(img).all()
    assert img.max() <= 10.0 + 1e-3  # nothing brighter than the emitter
    assert img.mean() > 0.01  # light got into the box
    # albedo AOV: center pixels see the white back wall
    albedo = aovs["albedo"]
    np.testing.assert_allclose(albedo[32, 32], [0.8, 0.8, 0.8], atol=0.05)
    # camera convention: right = cross(dir,+Y) = (-1,0,0) when looking +z,
    # so the red wall (world -x) appears on the image RIGHT.
    left = img[24:40, :16].mean(axis=(0, 1))
    right = img[24:40, 48:].mean(axis=(0, 1))
    assert right[0] > right[1]  # red dominates near red wall
    assert left[1] > left[0]  # green dominates near green wall


@pytest.mark.slow
def test_render_deterministic():
    opt = RenderOption(
        image_width=32,
        image_height=32,
        max_spp=8,
        spp_batch=4,
        camera_position=(0.0, 0.0, -4.5),
        camera_direction=(0.0, 0.0, 1.0),
    )
    imgs = []
    for _ in range(2):
        r = Renderer(option=opt)
        r.set_scene(cornell_box_scene())
        r.build()
        imgs.append(r.render_frame(0)["color"])
    np.testing.assert_array_equal(imgs[0], imgs[1])


def test_camera_rays_shape_and_center():
    cam = make_camera((0, 0, -4.5), (0, 0, 1), np.radians(45.0))
    n = 16
    state = make_cmj_state(
        jnp.zeros(n, dtype=jnp.uint32), jnp.arange(n, dtype=jnp.uint32)
    )
    o, d, _ = camera_rays(cam, 4, 4, jnp.arange(n, dtype=jnp.uint32), state)
    assert o.shape == (n, 3) and d.shape == (n, 3)
    np.testing.assert_allclose(np.linalg.norm(np.asarray(d), axis=-1), 1.0, atol=1e-5)
    # all rays point roughly +z
    assert np.all(np.asarray(d)[:, 2] > 0.5)
