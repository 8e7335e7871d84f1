"""LBVH build + traversal tests: correctness vs the brute-force oracle
(SURVEY.md §7 M4 test plan)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from henjou.accel.bruteforce import intersect_bruteforce, occluded_bruteforce
from henjou.accel.lbvh import build_lbvh, morton_codes
from henjou.accel.traverse import make_bvh_intersector, traverse_closest


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


def test_morton_orders_spatially():
    pts = jnp.asarray(
        [[0.0, 0.0, 0.0], [0.01, 0.01, 0.01], [1.0, 1.0, 1.0]], jnp.float32
    )
    lo = jnp.zeros(3)
    hi = jnp.ones(3)
    codes = np.asarray(morton_codes(pts, lo, hi))
    assert codes[0] <= codes[1] <= codes[2]


def test_lbvh_structure():
    tris = random_tris(100)
    bvh = build_lbvh(tris)
    t = 100
    left, right = np.asarray(bvh.left), np.asarray(bvh.right)
    # every node except the root has exactly one parent
    children = np.concatenate([left, right])
    assert len(children) == 2 * (t - 1)
    counts = np.bincount(children, minlength=2 * t - 1)
    assert counts[0] == 0  # root unparented
    np.testing.assert_array_equal(counts[1:], 1)
    # root AABB covers everything
    np.testing.assert_allclose(
        np.asarray(bvh.aabb_min[0]),
        np.asarray(tris.reshape(-1, 3).min(axis=0)),
        atol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(bvh.aabb_max[0]),
        np.asarray(tris.reshape(-1, 3).max(axis=0)),
        atol=1e-6,
    )
    # internal AABBs contain their children
    for node in range(t - 1):
        for ch in (left[node], right[node]):
            assert np.all(
                np.asarray(bvh.aabb_min[node]) <= np.asarray(bvh.aabb_min[ch]) + 1e-6
            )
            assert np.all(
                np.asarray(bvh.aabb_max[node]) >= np.asarray(bvh.aabb_max[ch]) - 1e-6
            )


@pytest.mark.slow
def test_traverse_matches_bruteforce():
    for ntri, seed in ((13, 2), (100, 3), (517, 4)):
        tris = random_tris(ntri, seed=seed)
        bvh = build_lbvh(tris)
        o, d = random_rays(256, seed=seed + 10)
        t_b, p_b, u_b, v_b, h_b = intersect_bruteforce(tris, o, d, 1e-3)
        t_t, p_t, u_t, v_t, h_t = traverse_closest(bvh, o, d, 1e-3)
        np.testing.assert_array_equal(np.asarray(h_b), np.asarray(h_t))
        hb = np.asarray(h_b)
        np.testing.assert_allclose(
            np.asarray(t_b)[hb], np.asarray(t_t)[hb], rtol=1e-5
        )
        np.testing.assert_array_equal(np.asarray(p_b)[hb], np.asarray(p_t)[hb])


@pytest.mark.slow
def test_traverse_occlusion_matches():
    tris = random_tris(200, seed=5)
    bvh = build_lbvh(tris)
    o, d = random_rays(256, seed=20)
    tmax = jnp.full((256,), 3.0)
    blocked_b = occluded_bruteforce(tris, o, d, 1e-3, tmax)
    _, occluded_fn = make_bvh_intersector(bvh)
    blocked_t = occluded_fn(None, o, d, 1e-3, tmax)
    np.testing.assert_array_equal(np.asarray(blocked_b), np.asarray(blocked_t))


def test_traverse_respects_tmin_tmax():
    tris = jnp.asarray(
        [[[-1.0, -1.0, 1.0], [3.0, -1.0, 1.0], [-1.0, 3.0, 1.0]],
         [[-1.0, -1.0, 2.0], [3.0, -1.0, 2.0], [-1.0, 3.0, 2.0]]],
        jnp.float32,
    )
    bvh = build_lbvh(tris)
    o = jnp.zeros((1, 3))
    d = jnp.asarray([[0.0, 0.0, 1.0]])
    t, p, _, _, h = traverse_closest(bvh, o, d, 1e-3)
    assert bool(h[0]) and float(t[0]) == 1.0 and int(p[0]) == 0
    # tmin beyond first triangle: hits the second
    t, p, _, _, h = traverse_closest(bvh, o, d, 1.5)
    assert bool(h[0]) and float(t[0]) == 2.0 and int(p[0]) == 1
    # tmax before first: miss
    t, p, _, _, h = traverse_closest(bvh, o, d, 1e-3, tmax=jnp.asarray([0.5]))
    assert not bool(h[0])


def test_single_triangle_bvh():
    tris = random_tris(1, seed=9)
    bvh = build_lbvh(tris)
    o, d = random_rays(64, seed=21)
    t_b, p_b, _, _, h_b = intersect_bruteforce(tris, o, d, 1e-3)
    t_t, p_t, _, _, h_t = traverse_closest(bvh, o, d, 1e-3)
    np.testing.assert_array_equal(np.asarray(h_b), np.asarray(h_t))


def test_degenerate_identical_centroids():
    """All triangles at the same centroid (identical Morton codes) — the
    index tie-break must still give a valid tree."""
    base = np.asarray(
        [[0.0, 0.0, 0.0], [0.1, 0.0, 0.0], [0.0, 0.1, 0.0]], np.float32
    )
    tris = jnp.asarray(np.stack([base for _ in range(33)]))
    bvh = build_lbvh(tris)
    o = jnp.asarray([[0.02, 0.02, -1.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0]])
    t, p, _, _, h = traverse_closest(bvh, o, d, 1e-3)
    assert bool(h[0])
    np.testing.assert_allclose(float(t[0]), 1.0, atol=1e-5)


@pytest.mark.slow
def test_closest_hit_with_bvh_on_cornell():
    from henjou.integrator.payload import Sky, closest_hit
    from henjou.scene.scenedata import build_device_scene, build_frame_scene
    from henjou.scene.testscenes import cornell_box_scene

    dev = build_device_scene(cornell_box_scene())
    frame = build_frame_scene(dev)
    bvh = build_lbvh(frame.tri_verts)
    intersect_fn, _ = make_bvh_intersector(bvh)
    sky = Sky(constant_color=jnp.zeros(3), intensity=jnp.asarray(1.0))
    o = jnp.asarray([[0.0, 0.0, 0.0]] * 4)
    d = jnp.asarray(
        [[-1.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
    )
    hit = closest_hit(frame, sky, o, d, intersect_fn=intersect_fn)
    assert np.asarray(hit.is_hit).all()
    np.testing.assert_allclose(np.asarray(hit.t), 1.0, atol=1e-3)
    np.testing.assert_allclose(
        np.asarray(hit.basecolor[0]), [0.8, 0.05, 0.05], atol=1e-6
    )  # red left wall
    np.testing.assert_allclose(
        np.asarray(hit.basecolor[1]), [0.05, 0.8, 0.05], atol=1e-6
    )  # green right wall


def test_jitted_build_equals_eager_on_animated_frames():
    """The renderer builds the LBVH with one jitted call per distinct
    transform set; on two frames of an animated scene it must equal the
    eager (op-by-op) build exactly."""
    from henjou.runtime.options import RenderOption
    from henjou.runtime.renderer import Renderer
    from henjou.scene.animation import static_animation
    from henjou.scene.testscenes import sphere_gallery_scene

    scene = sphere_gallery_scene()
    a = static_animation((0, 0, 0), (0, 0, 0, 1), (1, 1, 1))
    a.translation.keys = [0.0, 1.0]
    a.translation.values = [[0, 0, 0], [0.5, 0.2, 0]]
    scene.animations.append(a)
    for inst in scene.instances:
        inst.animation_id = len(scene.animations) - 1
    r = Renderer(option=RenderOption(fps=24))
    r.set_scene(scene).build()
    jitted = jax.jit(build_lbvh)
    verts = []
    for frame in (0, 12):
        xf, inv = r._frame_transforms(frame / 24.0)
        tv = r._frame_build(r.device_scene, xf, inv).tri_verts
        verts.append(np.asarray(tv))
        a_bvh, b_bvh = jitted(tv), build_lbvh(tv)
        for x, y in zip(jax.tree.leaves(a_bvh), jax.tree.leaves(b_bvh)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert not np.array_equal(verts[0], verts[1])  # the geometry moved
