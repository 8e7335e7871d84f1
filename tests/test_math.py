"""Unit tests for core shading math (SURVEY.md §7 M0)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from henjou.math import (
    cosine_sampling,
    cross,
    dot,
    hemisphere_sampling,
    local_to_world,
    normalize,
    orthonormal_basis,
    reflect,
    refract,
    schlick_fresnel_ior,
    transform_normal,
    transform_position,
    world_to_local,
)
from henjou.math.affine import (
    compose_affine,
    invert_affine,
    rotate_affine,
    scale_affine,
    translate_affine,
)


def rand_unit(n, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_onb_orthonormal():
    n = jnp.asarray(rand_unit(512))
    t, b = orthonormal_basis(n)
    np.testing.assert_allclose(dot(t, n), 0.0, atol=1e-5)
    np.testing.assert_allclose(dot(b, n), 0.0, atol=1e-5)
    np.testing.assert_allclose(dot(t, b), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(dot(t, t)), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(dot(b, b)), 1.0, atol=1e-5)


def test_world_local_roundtrip():
    n = jnp.asarray(rand_unit(128, seed=1))
    v = jnp.asarray(rand_unit(128, seed=2))
    t, b = orthonormal_basis(n)
    lv = world_to_local(v, t, n, b)
    wv = local_to_world(lv, t, n, b)
    np.testing.assert_allclose(np.asarray(wv), np.asarray(v), atol=1e-5)
    # normal maps to +Y
    ln = world_to_local(n, t, n, b)
    np.testing.assert_allclose(np.asarray(ln[:, 1]), 1.0, atol=1e-5)


def test_reflect():
    v = jnp.asarray([[1.0, -1.0, 0.0]])
    n = jnp.asarray([[0.0, 1.0, 0.0]])
    r = reflect(normalize(v), n)
    np.testing.assert_allclose(
        np.asarray(r[0]), np.asarray(normalize(jnp.asarray([[1.0, 1.0, 0.0]]))[0]), atol=1e-6
    )


def test_refract_snell():
    # incidence 45deg from vacuum into glass (ior 1.5)
    wo = normalize(jnp.asarray([[1.0, 1.0, 0.0]]))
    n = jnp.asarray([[0.0, 1.0, 0.0]])
    ok, t = refract(wo, n, 1.0, 1.5)
    assert bool(ok[0])
    sin_in = np.sqrt(1.0 - float(dot(wo, n)[0]) ** 2)
    sin_out = np.sqrt(float(t[0, 0]) ** 2 + float(t[0, 2]) ** 2)
    np.testing.assert_allclose(sin_out, sin_in / 1.5, atol=1e-6)
    assert float(t[0, 1]) < 0.0  # goes into the surface


def test_refract_tir():
    # grazing from dense to sparse: TIR
    wo = normalize(jnp.asarray([[1.0, 0.1, 0.0]]))
    n = jnp.asarray([[0.0, 1.0, 0.0]])
    ok, _ = refract(wo, n, 1.5, 1.0)
    assert not bool(ok[0])


def test_fresnel_normal_incidence():
    w = jnp.asarray([[0.0, 1.0, 0.0]])
    n = jnp.asarray([[0.0, 1.0, 0.0]])
    f = schlick_fresnel_ior(1.0, 1.5, w, n)
    np.testing.assert_allclose(float(f[0]), ((0.5 / 2.5) ** 2), atol=1e-6)


def test_cosine_sampling_distribution():
    # chi^2-ish check: E[cos] for cosine-weighted should be 2/3
    rng = np.random.default_rng(3)
    u = jnp.asarray(rng.uniform(size=20000).astype(np.float32))
    v = jnp.asarray(rng.uniform(size=20000).astype(np.float32))
    wi, pdf = cosine_sampling(u, v)
    assert np.all(np.asarray(wi[:, 1]) >= -1e-6)
    np.testing.assert_allclose(np.mean(np.asarray(wi[:, 1])), 2.0 / 3.0, atol=0.01)
    np.testing.assert_allclose(
        np.asarray(pdf), np.asarray(wi[:, 1]) / np.pi, atol=1e-5
    )


def test_hemisphere_sampling_pdf():
    rng = np.random.default_rng(4)
    u = jnp.asarray(rng.uniform(size=1000).astype(np.float32))
    v = jnp.asarray(rng.uniform(size=1000).astype(np.float32))
    wi, pdf = hemisphere_sampling(u, v)
    np.testing.assert_allclose(np.asarray(pdf), 1.0 / (2 * np.pi), atol=1e-6)
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(wi), axis=-1), 1.0, atol=1e-5
    )


def test_affine_compose_invert():
    m = compose_affine(
        translate_affine([1.0, 2.0, 3.0]),
        compose_affine(
            rotate_affine([0.0, 0.7071068, 0.0, 0.7071068]),
            scale_affine([2.0, 2.0, 2.0]),
        ),
    )
    inv = invert_affine(m)
    ident = compose_affine(m, inv)
    np.testing.assert_allclose(ident[:, :3], np.eye(3), atol=1e-5)
    np.testing.assert_allclose(ident[:, 3], 0.0, atol=1e-5)


def test_transform_position_normal():
    m = compose_affine(
        translate_affine([0.0, 1.0, 0.0]), scale_affine([2.0, 1.0, 1.0])
    )
    inv = invert_affine(m)
    p = transform_position(jnp.asarray(m), jnp.asarray([1.0, 0.0, 0.0]))
    np.testing.assert_allclose(np.asarray(p), [2.0, 1.0, 0.0], atol=1e-6)
    # normals use inverse-transpose: x-normal shrinks under x-scale then renormalizes
    nrm = transform_normal(jnp.asarray(inv), jnp.asarray([1.0, 0.0, 0.0]))
    nrm = np.asarray(normalize(nrm))
    np.testing.assert_allclose(nrm, [1.0, 0.0, 0.0], atol=1e-6)


def test_cross_matches_numpy():
    rng = np.random.default_rng(5)
    a = rng.normal(size=(64, 3)).astype(np.float32)
    b = rng.normal(size=(64, 3)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(cross(jnp.asarray(a), jnp.asarray(b))),
        np.cross(a, b),
        atol=1e-5,
    )
