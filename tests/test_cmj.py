"""CMJ sampler tests: bit-exactness vs a numpy oracle of the reference
algorithm (include/kernel/cmj.h) plus stratification checks (SURVEY.md §4/§7)."""

import jax.numpy as jnp
import numpy as np

from henjou.sampling import cmj_1d, cmj_2d, make_cmj_state, xxhash32


# ---- numpy oracle: direct transliteration of the reference algorithm ----
def np_u32(x):
    return np.uint32(x)


def oracle_xxhash32_u4(x, y, z, w):
    P2, P3 = np_u32(2246822519), np_u32(3266489917)
    P4, P5 = np_u32(668265263), np_u32(374761393)
    with np.errstate(over="ignore"):
        h = np_u32(w + P5 + np_u32(x * P3))
        h = np_u32(P4 * np_u32((h << np_u32(17)) | (h >> np_u32(15))))
        h = np_u32(h + np_u32(y * P3))
        h = np_u32(P4 * np_u32((h << np_u32(17)) | (h >> np_u32(15))))
        h = np_u32(h + np_u32(z * P3))
        h = np_u32(P4 * np_u32((h << np_u32(17)) | (h >> np_u32(15))))
        h = np_u32(P2 * (h ^ (h >> np_u32(15))))
        h = np_u32(P3 * (h ^ (h >> np_u32(13))))
    return h ^ (h >> np_u32(16))


def oracle_permute(i, l, p):
    i, l, p = np_u32(i), np_u32(l), np_u32(p)
    w = np_u32(l - 1)
    for shift in (1, 2, 4, 8, 16):
        w = np_u32(w | (w >> np_u32(shift)))
    with np.errstate(over="ignore"):
        while True:
            i ^= p
            i = np_u32(i * np_u32(0xE170893D))
            i ^= p >> np_u32(16)
            i ^= (i & w) >> np_u32(4)
            i ^= p >> np_u32(8)
            i = np_u32(i * np_u32(0x0929EB3F))
            i ^= p >> np_u32(23)
            i ^= (i & w) >> np_u32(1)
            i = np_u32(i * (np_u32(1) | (p >> np_u32(27))))
            i = np_u32(i * np_u32(0x6935FA69))
            i ^= (i & w) >> np_u32(11)
            i = np_u32(i * np_u32(0x74DCB303))
            i ^= (i & w) >> np_u32(2)
            i = np_u32(i * np_u32(0x9E501CC3))
            i ^= (i & w) >> np_u32(2)
            i = np_u32(i * np_u32(0xC860A3DF))
            i &= w
            i ^= i >> np_u32(5)
            if i < l:
                break
    return np_u32((i + p) % l)


def oracle_randfloat(i, p):
    i, p = np_u32(i), np_u32(p)
    with np.errstate(over="ignore"):
        i ^= p
        i ^= i >> np_u32(17)
        i ^= i >> np_u32(10)
        i = np_u32(i * np_u32(0xB36534E5))
        i ^= i >> np_u32(12)
        i ^= i >> np_u32(21)
        i = np_u32(i * np_u32(0x93FC4795))
        i ^= np_u32(0xDF6E307F)
        i ^= i >> np_u32(17)
        i = np_u32(i * (np_u32(1) | (p >> np_u32(18))))
    return np.float32(i) * np.float32(1.0 / 4294967808.0)


def oracle_cmj(index, scramble):
    M = N = 4
    with np.errstate(over="ignore"):
        index = oracle_permute(index, M * N, np_u32(scramble * np_u32(0x51633E2D)))
        sx = oracle_permute(index % M, M, np_u32(scramble * np_u32(0xA511E9B3)))
        sy = oracle_permute(index // M, N, np_u32(scramble * np_u32(0x63D83595)))
        jx = oracle_randfloat(index, np_u32(scramble * np_u32(0xA399D265)))
        jy = oracle_randfloat(index, np_u32(scramble * np_u32(0x711AD6A5)))
    # keep every intermediate in float32, matching the CUDA float math
    f = np.float32
    fx = f(f(f(index % M) + f(f(f(sy) + jx) / f(N))) / f(M))
    fy = f(f(f(index // M) + f(f(f(sx) + jy) / f(M))) / f(N))
    return fx, fy


def oracle_cmj_2d(n_spp, image_idx, depth, scramble):
    index = np_u32(n_spp % 16)
    s = oracle_xxhash32_u4(np_u32(n_spp // 16), np_u32(image_idx), np_u32(depth), np_u32(scramble))
    return oracle_cmj(index, s)


def test_xxhash32_matches_oracle():
    rng = np.random.default_rng(0)
    xs = rng.integers(0, 2**32, size=64, dtype=np.uint32)
    ys = rng.integers(0, 2**32, size=64, dtype=np.uint32)
    zs = rng.integers(0, 2**32, size=64, dtype=np.uint32)
    ws = rng.integers(0, 2**32, size=64, dtype=np.uint32)
    got = np.asarray(xxhash32(jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(zs), jnp.asarray(ws)))
    want = np.array(
        [oracle_xxhash32_u4(x, y, z, w) for x, y, z, w in zip(xs, ys, zs, ws)],
        dtype=np.uint32,
    )
    np.testing.assert_array_equal(got, want)


def test_cmj2d_bit_exact_vs_oracle():
    cases = [
        (0, 0, 0, 0),
        (1, 0, 0, 0),
        (15, 7, 3, 42),
        (16, 123456, 9, 7),
        (12345, 919, 31, 100),
        (999999, 2073600, 63, 12345),
    ]
    for n_spp, image_idx, depth, scramble in cases:
        st = make_cmj_state(
            jnp.asarray([n_spp], dtype=jnp.uint32),
            jnp.asarray([image_idx], dtype=jnp.uint32),
            seed=scramble,
        )
        st = st._replace(depth=jnp.asarray([depth], dtype=jnp.uint32))
        xi, st2 = cmj_2d(st)
        ox, oy = oracle_cmj_2d(n_spp, image_idx, depth, scramble)
        np.testing.assert_allclose(float(xi[0, 0]), ox, atol=0, rtol=0)
        np.testing.assert_allclose(float(xi[0, 1]), oy, atol=0, rtol=0)
        assert int(st2.depth[0]) == depth + 1


def test_cmj_range_and_stratification():
    # 16 consecutive spp indices at fixed pixel/depth tile the 4x4 strata
    st = make_cmj_state(
        jnp.arange(16, dtype=jnp.uint32),
        jnp.zeros(16, dtype=jnp.uint32),
        seed=5,
    )
    xi, _ = cmj_2d(st)
    xi = np.asarray(xi)
    assert np.all(xi >= 0.0) and np.all(xi < 1.0)
    cells = set()
    for x, y in xi:
        cells.add((int(x * 4), int(y * 4)))
    assert len(cells) == 16  # perfectly stratified over the 4x4 grid


def test_cmj_uniform_mean():
    # average of many draws approaches 0.5
    st = make_cmj_state(
        jnp.arange(4096, dtype=jnp.uint32) % 64,
        jnp.arange(4096, dtype=jnp.uint32),
        seed=11,
    )
    total = np.zeros(2)
    s = st
    for _ in range(8):
        xi, s = cmj_2d(s)
        total += np.asarray(xi).mean(axis=0)
    np.testing.assert_allclose(total / 8, 0.5, atol=0.01)


def test_cmj_1d_consumes_one_dim():
    st = make_cmj_state(
        jnp.asarray([3], dtype=jnp.uint32), jnp.asarray([9], dtype=jnp.uint32)
    )
    x, st2 = cmj_1d(st)
    assert int(st2.depth[0]) == 1
    assert 0.0 <= float(x[0]) < 1.0
