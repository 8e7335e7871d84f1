"""Brute-force intersector tests (ground truth for later BVH validation)."""

import jax.numpy as jnp
import numpy as np

from henjou.accel.bruteforce import intersect_bruteforce, occluded_bruteforce


def single_tri():
    return jnp.asarray(
        [[[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]], jnp.float32
    )


def test_hit_and_miss():
    tris = single_tri()
    o = jnp.asarray([[0.25, 0.25, -1.0], [2.0, 2.0, -1.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    t, prim, u, v, hit = intersect_bruteforce(tris, o, d, 1e-3)
    assert bool(hit[0]) and not bool(hit[1])
    np.testing.assert_allclose(float(t[0]), 1.0, atol=1e-6)
    assert int(prim[0]) == 0
    np.testing.assert_allclose(float(u[0]), 0.25, atol=1e-6)
    np.testing.assert_allclose(float(v[0]), 0.25, atol=1e-6)


def test_tmin_tmax_window():
    tris = single_tri()
    o = jnp.asarray([[0.25, 0.25, -1.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0]])
    _, _, _, _, hit = intersect_bruteforce(tris, o, d, 1e-3, tmax=0.5)
    assert not bool(hit[0])
    _, _, _, _, hit = intersect_bruteforce(tris, o, d, 1.5)
    assert not bool(hit[0])


def test_backface_hits():
    # glass needs interior hits: ray from behind must still intersect
    tris = single_tri()
    o = jnp.asarray([[0.25, 0.25, 1.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    _, _, _, _, hit = intersect_bruteforce(tris, o, d, 1e-3)
    assert bool(hit[0])


def test_closest_of_many():
    rng = np.random.default_rng(0)
    # 300 parallel unit triangles at random z depths (crosses chunk boundary)
    z = rng.uniform(1.0, 100.0, size=300).astype(np.float32)
    tris = np.zeros((300, 3, 3), np.float32)
    tris[:, 0] = np.stack([-np.ones(300), -np.ones(300), z], axis=-1)
    tris[:, 1] = np.stack([3 * np.ones(300), -np.ones(300), z], axis=-1)
    tris[:, 2] = np.stack([-np.ones(300), 3 * np.ones(300), z], axis=-1)
    o = jnp.zeros((1, 3))
    d = jnp.asarray([[0.0, 0.0, 1.0]])
    t, prim, _, _, hit = intersect_bruteforce(jnp.asarray(tris), o, d, 1e-3)
    assert bool(hit[0])
    assert int(prim[0]) == int(np.argmin(z))
    np.testing.assert_allclose(float(t[0]), float(z.min()), rtol=1e-6)


def test_occlusion_window():
    tris = single_tri()
    o = jnp.asarray([[0.25, 0.25, -1.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0]])
    assert bool(occluded_bruteforce(tris, o, d, 1e-3, jnp.asarray([2.0]))[0])
    # occluder beyond tmax does not block
    assert not bool(occluded_bruteforce(tris, o, d, 1e-3, jnp.asarray([0.9]))[0])


def test_random_rays_vs_numpy_oracle():
    rng = np.random.default_rng(7)
    tris = rng.uniform(-1, 1, size=(50, 3, 3)).astype(np.float32)
    o = rng.uniform(-2, 2, size=(64, 3)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    t, prim, _, _, hit = intersect_bruteforce(
        jnp.asarray(tris), jnp.asarray(o), jnp.asarray(d), 1e-3
    )

    # numpy Möller-Trumbore oracle
    v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
    e1, e2 = v1 - v0, v2 - v0
    for r in range(64):
        pvec = np.cross(d[r], e2)
        det = np.einsum("ij,ij->i", e1, pvec)
        ok = np.abs(det) > 1e-12
        inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
        tvec = o[r] - v0
        u = np.einsum("ij,ij->i", tvec, pvec) * inv
        qvec = np.cross(tvec, e1)
        vv = np.einsum("j,ij->i", d[r], qvec) * inv
        tt = np.einsum("ij,ij->i", e2, qvec) * inv
        valid = ok & (u >= 0) & (vv >= 0) & (u + vv <= 1) & (tt > 1e-3)
        if valid.any():
            want_t = tt[valid].min()
            assert bool(hit[r])
            np.testing.assert_allclose(float(t[r]), want_t, rtol=1e-4)
        else:
            assert not bool(hit[r])
