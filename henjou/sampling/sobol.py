"""Owen-scrambled Sobol sampling (hash-based, Burley 2020).

Quality-per-second lever beyond the reference: the reference's CMJ
sampler (include/kernel/cmj.h, ported bit-exactly in sampling/cmj.py)
stratifies each 2D draw over a fixed 4x4 grid — past 16 spp the strata
repeat and convergence falls back toward sqrt(N). A padded
Owen-scrambled Sobol (0,2)-sequence stays stratified at EVERY
power-of-two prefix, so the 32-500 spp regime the 300 s contest budget
actually reaches integrates visibly better per sample.

Design (the pbrt-v4 / Burley "Practical Hash-based Owen Scrambling"
construction, restated):
  - every 2D draw uses Sobol dims (0,1): dim0 = van der Corput
    (bit-reversed index), dim1 = the classic x+1-polynomial direction
    matrix (m = 1,3,5,15,17,51,85,255,...)
  - per-(pixel, dimension-counter, seed) hash keys drive (a) a
    hierarchy-preserving shuffle of the sample index (decorrelates the
    padded dimension pairs) and (b) an Owen scramble of each output
    (breaks the raw sequence's diagonal correlation)
  - all pure uint32 hashing: no tables beyond 32 direction
    constants folded into the trace, no memory traffic, counter-based
    like the CMJ sampler so refilled wavefront lanes reproduce their
    stream exactly.

The sampler is selected per STATE via a tag bit (sampling/cmj.py
SOBOL_SEED_FLAG): draws stay a single code path on the lockstep vector
unit; tagged lanes take the Sobol values, untagged the CMJ values.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

_U32 = jnp.uint32


def _u32(x):
    return jnp.asarray(x, dtype=_U32)


def _gen_dim2_dirs() -> np.ndarray:
    """Direction numbers v_k = m_k << (32-k) for Sobol dimension 2
    (primitive polynomial x+1; recurrence m_k = (m_{k-1} << 1) ^ m_{k-1},
    m_1 = 1 -> 1,3,5,15,17,51,85,255,...)."""
    m = np.zeros(33, np.uint64)
    m[1] = 1
    for k in range(2, 33):
        m[k] = (m[k - 1] << 1) ^ m[k - 1]
    v = np.zeros(32, np.uint32)
    for k in range(1, 33):
        v[k - 1] = np.uint32((m[k] << np.uint64(32 - k)) & np.uint64(0xFFFFFFFF))
    return v


_DIM2_DIRS = tuple(int(x) for x in _gen_dim2_dirs())


def reverse_bits_u32(x):
    """Bit-reverse a u32 (5 shift/mask stages) — Sobol dim 0 and the
    inner step of the nested-uniform scramble."""
    x = _u32(x)
    x = ((x & _u32(0x55555555)) << 1) | ((x >> 1) & _u32(0x55555555))
    x = ((x & _u32(0x33333333)) << 2) | ((x >> 2) & _u32(0x33333333))
    x = ((x & _u32(0x0F0F0F0F)) << 4) | ((x >> 4) & _u32(0x0F0F0F0F))
    x = ((x & _u32(0x00FF00FF)) << 8) | ((x >> 8) & _u32(0x00FF00FF))
    return (x << 16) | (x >> 16)


def _laine_karras(x, seed):
    """Laine-Karras-style hash whose bit i depends only on bits <= i of
    the input — i.e. a valid per-level Owen permutation of the binary
    tree when applied to a bit-REVERSED value (Burley 2020, listing 3)."""
    x = _u32(x)
    x = x + _u32(seed)
    x = x ^ (x * _u32(0x6C50B47C))
    x = x ^ (x * _u32(0xB82F1E52))
    x = x ^ (x * _u32(0xC7AFE638))
    x = x ^ (x * _u32(0x8D22F6E6))
    return x


def nested_uniform_scramble(x, seed):
    """Owen scramble of a u32 sample value (or, applied to a sample
    INDEX, a stratification-preserving shuffle of the sequence order)."""
    return reverse_bits_u32(_laine_karras(reverse_bits_u32(x), seed))


def _sobol_dim2_u32(index):
    """Sobol dimension-2 value: XOR of direction numbers at set index
    bits. 32 static select/xor steps, folded flat into the trace."""
    index = _u32(index)
    out = jnp.zeros_like(index)
    for k in range(32):
        take = (index >> k) & _u32(1)
        out = out ^ (take * _u32(_DIM2_DIRS[k]))
    return out


def _hash_key(a, b, c):
    """Mix (pixel, dim, seed) into independent per-draw scramble keys
    (xxhash32 finalizer over a simple combine; full avalanche)."""
    h = _u32(a) * _u32(0x9E3779B1) + _u32(b) * _u32(0x85EBCA77) + _u32(c)
    h = _u32(0xC2B2AE3D) * (h ^ (h >> 15))
    h = _u32(0x27D4EB2F) * (h ^ (h >> 13))
    return h ^ (h >> 16)


# (v >> 8) * 2^-24: 24 mantissa-exact bits, result strictly < 1.0
_INV_2_24 = jnp.float32(1.0 / 16777216.0)


def sobol_pair(n_spp, image_idx, dim, seed):
    """One padded Owen-Sobol 2D draw.

    n_spp: absolute per-pixel sample index (u32)
    image_idx: global pixel id (u32) — with `dim` and `seed`, keys the
      shuffle/scramble hashes
    dim: the per-lane dimension counter (u32; one per 2D draw)
    Returns (fx, fy) float32 in [0, 1)."""
    k_shuffle = _hash_key(image_idx, dim, _u32(seed) ^ _u32(0x5B1DE5A7))
    k_x = _hash_key(image_idx, dim, _u32(seed) ^ _u32(0xA341316C))
    k_y = _hash_key(image_idx, dim, _u32(seed) ^ _u32(0xC8013EA4))
    idx = nested_uniform_scramble(n_spp, k_shuffle)
    ux = nested_uniform_scramble(reverse_bits_u32(idx), k_x)
    uy = nested_uniform_scramble(_sobol_dim2_u32(idx), k_y)
    fx = (ux >> 8).astype(jnp.float32) * _INV_2_24
    fy = (uy >> 8).astype(jnp.float32) * _INV_2_24
    return fx, fy
