"""Cluster-scan intersector tests vs the brute-force oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from henjou.accel.bruteforce import intersect_bruteforce, occluded_bruteforce
from henjou.accel.cluster import (
    build_clusters,
    intersect_clusters,
    make_cluster_intersector,
)


def random_tris(n, seed=0, spread=4.0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-spread, spread, size=(n, 1, 3))
    offsets = rng.uniform(-0.3, 0.3, size=(n, 3, 3))
    return jnp.asarray((centers + offsets).astype(np.float32))


def random_rays(n, seed=1, spread=6.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def test_build_shapes_and_aabbs():
    tris = random_tris(100)
    cs = build_clusters(tris, k=64)
    assert cs.num_clusters == 2
    assert cs.tris.shape == (2, 64, 3, 3)
    # padding marked
    assert int((np.asarray(cs.tri_order) < 0).sum()) == 28
    # AABBs contain their (valid) triangles
    order = np.asarray(cs.tri_order)
    t_np = np.asarray(cs.tris)
    for c in range(2):
        valid = order[c] >= 0
        mn = t_np[c][valid].reshape(-1, 3).min(0)
        mx = t_np[c][valid].reshape(-1, 3).max(0)
        np.testing.assert_allclose(np.asarray(cs.aabb_min[c]), mn, atol=1e-6)
        np.testing.assert_allclose(np.asarray(cs.aabb_max[c]), mx, atol=1e-6)


@pytest.mark.slow
def test_matches_bruteforce():
    for ntri, seed in ((13, 2), (100, 3), (1000, 4)):
        tris = random_tris(ntri, seed=seed)
        cs = build_clusters(tris)
        o, d = random_rays(512, seed=seed + 10)
        t_b, p_b, u_b, v_b, h_b = intersect_bruteforce(tris, o, d, 1e-3)
        t_c, p_c, u_c, v_c, h_c = jax.jit(
            lambda o, d: intersect_clusters(cs, o, d, 1e-3)
        )(o, d)
        np.testing.assert_array_equal(np.asarray(h_b), np.asarray(h_c))
        hb = np.asarray(h_b)
        np.testing.assert_allclose(np.asarray(t_b)[hb], np.asarray(t_c)[hb], rtol=1e-5)
        np.testing.assert_array_equal(np.asarray(p_b)[hb], np.asarray(p_c)[hb])


def test_occlusion_matches():
    tris = random_tris(300, seed=5)
    cs = build_clusters(tris)
    o, d = random_rays(256, seed=20)
    tmax = jnp.full((256,), 3.0)
    blocked_b = occluded_bruteforce(tris, o, d, 1e-3, tmax)
    _, occluded_fn = make_cluster_intersector(cs)
    blocked_c = occluded_fn(None, o, d, 1e-3, tmax)
    np.testing.assert_array_equal(np.asarray(blocked_b), np.asarray(blocked_c))


@pytest.mark.slow
def test_tmin_tmax_and_inside():
    tris = jnp.asarray(
        [
            [[-1.0, -1.0, 1.0], [3.0, -1.0, 1.0], [-1.0, 3.0, 1.0]],
            [[-1.0, -1.0, 2.0], [3.0, -1.0, 2.0], [-1.0, 3.0, 2.0]],
        ],
        jnp.float32,
    )
    cs = build_clusters(tris)
    o = jnp.zeros((1, 3))
    d = jnp.asarray([[0.0, 0.0, 1.0]])
    t, p, _, _, h = intersect_clusters(cs, o, d, 1e-3)
    assert bool(h[0]) and float(t[0]) == 1.0 and int(p[0]) == 0
    t, p, _, _, h = intersect_clusters(cs, o, d, 1.5)
    assert bool(h[0]) and float(t[0]) == 2.0 and int(p[0]) == 1
    _, _, _, _, h = intersect_clusters(cs, o, d, 1e-3, tmax=jnp.asarray([0.5]))
    assert not bool(h[0])


@pytest.mark.slow
def test_renderer_uses_clusters_on_cornell():
    from henjou.integrator.payload import Sky, closest_hit
    from henjou.scene.scenedata import build_device_scene, build_frame_scene
    from henjou.scene.testscenes import cornell_box_scene

    dev = build_device_scene(cornell_box_scene())
    frame = build_frame_scene(dev)
    cs = build_clusters(frame.tri_verts)
    intersect_fn, _ = make_cluster_intersector(cs)
    sky = Sky(constant_color=jnp.zeros(3), intensity=jnp.asarray(1.0))
    o = jnp.asarray([[0.0, 0.0, 0.0]] * 2)
    d = jnp.asarray([[-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    hit = closest_hit(frame, sky, o, d, intersect_fn=intersect_fn)
    assert np.asarray(hit.is_hit).all()
    np.testing.assert_allclose(np.asarray(hit.t), 1.0, atol=1e-3)
