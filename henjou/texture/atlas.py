"""Texture atlas: all scene textures in one device array.

Replacement for the reference's per-texture cudaTextureObject binds
(renderer.h:740-800). Heterogeneous images are shelf-packed into a single
[H,W,4] f32 array; the sampler wraps UVs inside each sub-rectangle and
does the bilinear footprint manually (wrap + bilinear, matching the
reference's sampler config; sRGB decode already happened at load time).
"""

from __future__ import annotations

import dataclasses
from typing import List

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TextureAtlas:
    data: jnp.ndarray  # [AH,AW,4] f32
    offset: jnp.ndarray  # [N,2] i32 (y, x)
    size: jnp.ndarray  # [N,2] i32 (h, w)


def build_atlas(textures: List) -> TextureAtlas:
    """Shelf-pack Texture objects (texture.Texture). Always yields at least
    a 1x1 white atlas so the pytree structure is scene-independent."""
    if not textures:
        return TextureAtlas(
            data=jnp.ones((1, 1, 4), jnp.float32),
            offset=jnp.zeros((1, 2), jnp.int32),
            size=jnp.ones((1, 2), jnp.int32),
        )

    order = sorted(range(len(textures)), key=lambda i: -textures[i].height)
    atlas_w = max(max(t.width for t in textures), 64)
    # shelf packing
    pos = [None] * len(textures)
    shelf_y, shelf_h, cur_x = 0, 0, 0
    for i in order:
        t = textures[i]
        if cur_x + t.width > atlas_w:
            shelf_y += shelf_h
            shelf_h, cur_x = 0, 0
        pos[i] = (shelf_y, cur_x)
        cur_x += t.width
        shelf_h = max(shelf_h, t.height)
    atlas_h = shelf_y + shelf_h

    data = np.zeros((atlas_h, atlas_w, 4), np.float32)
    offset = np.zeros((len(textures), 2), np.int32)
    size = np.zeros((len(textures), 2), np.int32)
    for i, t in enumerate(textures):
        y, x = pos[i]
        data[y : y + t.height, x : x + t.width] = t.data[..., :4]
        offset[i] = (y, x)
        size[i] = (t.height, t.width)
    return TextureAtlas(
        data=jnp.asarray(data), offset=jnp.asarray(offset), size=jnp.asarray(size)
    )


def sample_atlas_rect(data: jnp.ndarray, rect: jnp.ndarray, u, v) -> jnp.ndarray:
    """Bilinear wrap sample with the atlas rect carried per lane.

    `rect` is [R,4] (oy, ox, h, w) — prefetched from the packed material
    row (scenedata.MAT_*_RECT), so no per-texture offset/size table gathers
    remain: 4 data gathers per sample, total. h == 0 means "no texture"
    (returns white). Returns [R,4]."""
    oy = rect[:, 0].astype(jnp.int32)
    ox = rect[:, 1].astype(jnp.int32)
    hi = jnp.maximum(rect[:, 2].astype(jnp.int32), 1)
    wi = jnp.maximum(rect[:, 3].astype(jnp.int32), 1)
    h = hi.astype(jnp.float32)
    w = wi.astype(jnp.float32)

    # wrap addressing, texel centers at (i+0.5)/W
    x = (u - jnp.floor(u)) * w - 0.5
    y = (v - jnp.floor(v)) * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]

    x0i = jnp.mod(x0.astype(jnp.int32), wi)
    y0i = jnp.mod(y0.astype(jnp.int32), hi)
    x1i = jnp.mod(x0i + 1, wi)
    y1i = jnp.mod(y0i + 1, hi)

    t00 = data[oy + y0i, ox + x0i]
    t10 = data[oy + y0i, ox + x1i]
    t01 = data[oy + y1i, ox + x0i]
    t11 = data[oy + y1i, ox + x1i]
    top = t00 * (1.0 - fx) + t10 * fx
    bot = t01 * (1.0 - fx) + t11 * fx
    out = top * (1.0 - fy) + bot * fy
    return jnp.where((rect[:, 2] > 0.0)[:, None], out, jnp.ones_like(out))


def sample_atlas(atlas: TextureAtlas, tex_id: jnp.ndarray, u, v) -> jnp.ndarray:
    """Bilinear wrap sample: tex_id [R] i32 (-1 -> white), u/v [R].
    Returns [R,4]."""
    tid = jnp.maximum(tex_id, 0)
    off = atlas.offset[tid]  # [R,2]
    sz = atlas.size[tid]
    h = sz[:, 0].astype(jnp.float32)
    w = sz[:, 1].astype(jnp.float32)

    # wrap addressing, texel centers at (i+0.5)/W
    x = (u - jnp.floor(u)) * w - 0.5
    y = (v - jnp.floor(v)) * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]

    wi = sz[:, 1]
    hi = sz[:, 0]
    x0i = jnp.mod(x0.astype(jnp.int32), wi)
    y0i = jnp.mod(y0.astype(jnp.int32), hi)
    x1i = jnp.mod(x0i + 1, wi)
    y1i = jnp.mod(y0i + 1, hi)

    oy = off[:, 0]
    ox = off[:, 1]
    t00 = atlas.data[oy + y0i, ox + x0i]
    t10 = atlas.data[oy + y0i, ox + x1i]
    t01 = atlas.data[oy + y1i, ox + x0i]
    t11 = atlas.data[oy + y1i, ox + x1i]
    top = t00 * (1.0 - fx) + t10 * fx
    bot = t01 * (1.0 - fx) + t11 * fx
    out = top * (1.0 - fy) + bot * fy
    return jnp.where((tex_id >= 0)[:, None], out, jnp.ones_like(out))
