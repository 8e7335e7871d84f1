"""Equirectangular IBL environment sampling.

The reference binds the HDR env map as a float4 texture and samples it in
the (absent) miss program with an equirect lookup scaled by ibl_intensity
(setSky renderer.h:802-851; behavior reconstructed per SURVEY.md §0).
Convention: v = acos(y)/pi (zenith up), u = atan2(z, x) wrapped.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from henjou.texture.sampler import sample_bilinear_wrap


def sample_equirect(tex: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """tex [H,W,3|4] f32, d [...,3] unit directions -> [...,3]."""
    phi = jnp.arctan2(d[..., 2], d[..., 0])
    u = phi / (2.0 * np.pi) + 0.5
    v = jnp.arccos(jnp.clip(d[..., 1], -1.0, 1.0)) / np.pi
    out = sample_bilinear_wrap(tex, u, v)
    return out[..., :3]


def load_ibl(path: str) -> jnp.ndarray:
    from henjou.texture.hdr import read_hdr

    return jnp.asarray(read_hdr(path))
