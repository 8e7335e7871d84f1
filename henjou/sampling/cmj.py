"""Correlated multi-jittered sampling, vectorized and functional.

Bit-exact rebuild of the reference sampler (include/kernel/cmj.h): 4x4 CMJ
strata with an xxhash32 scramble keyed on (sample index, pixel index,
dimension counter, seed) and Kensler permutations. Pure uint32 integer
hashing — no state tables, no memory traffic.

The CUDA version mutates `state.depth` per draw; here the state is an
immutable pytree threaded functionally: every draw returns
(value, new_state). All fields are uint32 arrays batched over rays.

Note on the permute loop: the reference's do/while (cmj.h:70-89) re-hashes
until i < l. For l <= 32 the trailing `i &= w; i ^= i >> 5` already
guarantees i < l after ONE pass (i < 32 implies i >> 5 == 0), and this
sampler only ever calls it with l in {4, 16}; this port therefore runs
the body exactly once, which is bit-identical, branch-free, and lockstep.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from henjou.sampling.sobol import sobol_pair

CMJ_M = 4
CMJ_N = 4

# Seed tag bit selecting the Owen-scrambled Sobol sampler for a state
# (sampling/sobol.py): draws through cmj_2d stay one lockstep code path
# and tagged lanes take the Sobol values. The low 31 seed bits behave
# identically in both modes; untagged states are BIT-EXACT with the
# reference CMJ sampler (the oracle test pins this).
SOBOL_SEED_FLAG = 0x80000000

# Trace-time gate for the Sobol branch in cmj_2d. The runtime tag bit
# only SELECTS between the two streams; without this gate the default
# sampler="cmj" path would still compute the ~100-op/lane Sobol pair on
# every draw of every bounce and discard it. The Renderer sets this from
# options before tracing; direct users of tagged seeds must call
# set_sobol_enabled(True) first (states without the tag are unaffected
# either way).
_SOBOL_TRACE_ENABLED = False


def set_sobol_enabled(on: bool) -> None:
    global _SOBOL_TRACE_ENABLED
    _SOBOL_TRACE_ENABLED = bool(on)


def sobol_enabled() -> bool:
    return _SOBOL_TRACE_ENABLED


_U32 = jnp.uint32


def _u32(x):
    return jnp.asarray(x, dtype=_U32)


class CMJState(NamedTuple):
    """Per-lane sampler state (reference: cmj.h:53-58)."""

    n_spp: jnp.ndarray  # sample index within the pixel
    scramble: jnp.ndarray  # global seed
    depth: jnp.ndarray  # dimension counter, bumped per draw
    image_idx: jnp.ndarray  # pixel index


def make_cmj_state(n_spp, image_idx, seed=0) -> CMJState:
    n_spp = _u32(n_spp)
    image_idx = _u32(image_idx)
    # every field mixes in 0*n_spp + 0*image_idx so the whole state is
    # uniformly varying under shard_map when either input is (loop carries
    # require matching varying-axis types; see accel/traverse.py note)
    vary = jnp.broadcast_to(n_spp * _u32(0), image_idx.shape) + image_idx * _u32(0)
    return CMJState(
        n_spp=jnp.broadcast_to(n_spp, vary.shape).astype(_U32) + vary,
        scramble=jnp.broadcast_to(_u32(seed), vary.shape).astype(_U32) + vary,
        depth=vary,
        image_idx=image_idx + vary,
    )


def xxhash32(x, y, z, w):
    """xxhash32 of a uint4 (reference: cmj.h:38-51)."""
    PRIME32_2 = _u32(2246822519)
    PRIME32_3 = _u32(3266489917)
    PRIME32_4 = _u32(668265263)
    PRIME32_5 = _u32(374761393)
    x, y, z, w = _u32(x), _u32(y), _u32(z), _u32(w)
    h = w + PRIME32_5 + x * PRIME32_3
    h = PRIME32_4 * ((h << 17) | (h >> 15))
    h = h + y * PRIME32_3
    h = PRIME32_4 * ((h << 17) | (h >> 15))
    h = h + z * PRIME32_3
    h = PRIME32_4 * ((h << 17) | (h >> 15))
    h = PRIME32_2 * (h ^ (h >> 15))
    h = PRIME32_3 * (h ^ (h >> 13))
    return h ^ (h >> 16)


def _cmj_permute_small(i, l: int, p):
    """Kensler permutation for power-of-two l <= 32 (single pass of the
    reference do/while, see module docstring). reference: cmj.h:60-91."""
    w = _u32(l - 1)
    i = _u32(i)
    p = _u32(p)
    i = i ^ p
    i = i * _u32(0xE170893D)
    i = i ^ (p >> 16)
    i = i ^ ((i & w) >> 4)
    i = i ^ (p >> 8)
    i = i * _u32(0x0929EB3F)
    i = i ^ (p >> 23)
    i = i ^ ((i & w) >> 1)
    i = i * (_u32(1) | (p >> 27))
    i = i * _u32(0x6935FA69)
    i = i ^ ((i & w) >> 11)
    i = i * _u32(0x74DCB303)
    i = i ^ ((i & w) >> 2)
    i = i * _u32(0x9E501CC3)
    i = i ^ ((i & w) >> 2)
    i = i * _u32(0xC860A3DF)
    i = i & w
    i = i ^ (i >> 5)
    return (i + p) % _u32(l)


def _cmj_randfloat(i, p):
    """Integer-hash float in [0, 1). reference: cmj.h:93-106."""
    i = _u32(i)
    p = _u32(p)
    i = i ^ p
    i = i ^ (i >> 17)
    i = i ^ (i >> 10)
    i = i * _u32(0xB36534E5)
    i = i ^ (i >> 12)
    i = i ^ (i >> 21)
    i = i * _u32(0x93FC4795)
    i = i ^ _u32(0xDF6E307F)
    i = i ^ (i >> 17)
    i = i * (_u32(1) | (p >> 18))
    return i.astype(jnp.float32) * jnp.float32(1.0 / 4294967808.0)


def _cmj(index, scramble):
    """One 2D CMJ sample from stratum `index` (reference: cmj.h:108-117)."""
    index = _cmj_permute_small(index, CMJ_M * CMJ_N, scramble * _u32(0x51633E2D))
    sx = _cmj_permute_small(index % _u32(CMJ_M), CMJ_M, scramble * _u32(0xA511E9B3))
    sy = _cmj_permute_small(index // _u32(CMJ_M), CMJ_N, scramble * _u32(0x63D83595))
    jx = _cmj_randfloat(index, scramble * _u32(0xA399D265))
    jy = _cmj_randfloat(index, scramble * _u32(0x711AD6A5))
    fx = (
        (index % _u32(CMJ_M)).astype(jnp.float32)
        + (sy.astype(jnp.float32) + jx) / CMJ_N
    ) / CMJ_M
    fy = (
        (index // _u32(CMJ_M)).astype(jnp.float32)
        + (sx.astype(jnp.float32) + jy) / CMJ_M
    ) / CMJ_N
    return fx, fy


def cmj_2d(state: CMJState):
    """Draw a 2D sample; returns ((x, y), new_state). reference: cmj.h:119-128.

    When the trace-time gate is on (set_sobol_enabled), states tagged
    with SOBOL_SEED_FLAG take the padded Owen-scrambled Sobol draw
    instead (sampling/sobol.py) — both primitives are pure u32
    hashing, and selecting keeps every draw site a single traced code
    path. With the gate off (the default, sampler="cmj") the Sobol pair
    is never traced, so the bit-exact reference path stays free."""
    index = state.n_spp % _u32(CMJ_M * CMJ_N)
    scramble = xxhash32(
        state.n_spp // _u32(CMJ_M * CMJ_N),
        state.image_idx,
        state.depth,
        state.scramble,
    )
    fx, fy = _cmj(index, scramble)
    if _SOBOL_TRACE_ENABLED:
        sx, sy = sobol_pair(
            state.n_spp,
            state.image_idx,
            state.depth,
            state.scramble & _u32(~SOBOL_SEED_FLAG & 0xFFFFFFFF),
        )
        tag = (state.scramble & _u32(SOBOL_SEED_FLAG)) != _u32(0)
        fx = jnp.where(tag, sx, fx)
        fy = jnp.where(tag, sy, fy)
    new_state = state._replace(depth=state.depth + _u32(1))
    return jnp.stack([fx, fy], axis=-1), new_state


def cmj_1d(state: CMJState):
    """reference: cmj.h:130-133 (a 2D draw, x component)."""
    xi, state = cmj_2d(state)
    return xi[..., 0], state


def cmj_3d(state: CMJState):
    xi2, state = cmj_2d(state)
    x1, state = cmj_1d(state)
    return jnp.concatenate([xi2, x1[..., None]], axis=-1), state


def cmj_4d(state: CMJState):
    a, state = cmj_2d(state)
    b, state = cmj_2d(state)
    return jnp.concatenate([a, b], axis=-1), state
