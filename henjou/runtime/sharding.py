"""Multi-device scaling: spp/tile sharding over a 1-D device mesh.

The reference is strictly single-GPU (SURVEY.md §2.5); this module is the
capability-equivalent scale-out. Strategy (SURVEY.md §7):

- **spp sharding** (default): every chip renders the full pixel tile with
  a disjoint slice of the sample indices (the CMJ sampler is counter-based
  so shifting n_spp by the device index is exactly sample partitioning),
  then partial accumulators are reduced with `psum`. Any pixel's
  samples stay chip-local; the only traffic is one [lanes,3]-sized reduce
  per batch.
- **tile sharding**: pixels are partitioned across chips instead; no
  collective is needed until image assembly (all_gather at the end). This
  is preferable when lanes >> spp.

Both are expressed with `shard_map` over a 1-D `Mesh` so XLA inserts the
collectives.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(devices=None, axis: str = "d") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    import numpy as np

    return Mesh(np.asarray(devices), (axis,))


def spp_sharded_step(
    render_one_spp: Callable,
    mesh: Mesh,
    axis: str = "d",
):
    """Wrap `render_one_spp(spp_idx[lanes] u32) -> (color, albedo, normal)`
    ([lanes,3] each) into a step that renders `n_dev` spp at once — one per
    chip — and psum-averages the partials.

    Returns step(spp_start: u32 scalar) -> mean over the device axis.
    """
    n_dev = mesh.shape[axis]

    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis),),
        out_specs=(P(), P(), P()),
    )
    def step(spp_offsets):
        # spp_offsets: this device's [1] slice of the per-device offsets
        c, a, n = render_one_spp(spp_offsets[0])
        c = jax.lax.psum(c, axis) / n_dev
        a = jax.lax.psum(a, axis) / n_dev
        n = jax.lax.psum(n, axis) / n_dev
        return c, a, n

    def run(spp_start):
        offsets = spp_start + jnp.arange(n_dev, dtype=jnp.uint32)
        return step(offsets)

    return run


def wavefront_sharded_step(
    wavefront_fn: Callable,
    mesh: Mesh,
    spp_per_device: int,
    axis: str = "d",
):
    """Shard the WAVEFRONT engine over chips by sample slices: device k
    runs `wavefront_fn(spp_offset)` (a full refilling-pool render of
    `spp_per_device` samples per pixel, returning a WavefrontFilm of
    per-pixel sums) on its own disjoint spp range, then the partial films
    are psum-reduced. Lane pools never communicate mid-render — the only
    traffic is one [P,3]-sized reduce per call, exactly like the masked
    spp sharding."""
    n_dev = mesh.shape[axis]

    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis),),
        out_specs=(P(), P(), P(), P(), P(), P()),
        # the FFI traversal kernel inside the per-device body returns
        # outputs without a vma annotation; disable the varying-mesh-axes
        # check rather than thread vma through the call (outputs are
        # reduced with an explicit psum below, so the collective contract
        # is explicit)
        check_vma=False,
    )
    def step(spp_offsets):
        film = wavefront_fn(spp_offsets[0])
        color = jax.lax.psum(film.color, axis)
        albedo = jax.lax.psum(film.albedo, axis)
        normal = jax.lax.psum(film.normal, axis)
        traces = jax.lax.psum(film.n_traces, axis)
        # variance/count columns ride the same reduce (adaptive
        # allocation and the variance-guided denoiser stay sharding-
        # transparent: per-pixel sums are associative)
        m2 = jax.lax.psum(film.m2, axis)
        count = jax.lax.psum(film.count, axis)
        return color, albedo, normal, traces, m2, count

    def run(spp_start):
        offsets = spp_start + spp_per_device * jnp.arange(n_dev, dtype=jnp.uint32)
        return step(offsets)

    return run


def tile_sharded_step(
    render_pixels: Callable,
    mesh: Mesh,
    axis: str = "d",
):
    """Wrap `render_pixels(pixel_idx[tile] u32, spp_idx scalar) -> [tile,3]*3`
    into a step that shards the pixel axis across chips and all_gathers the
    image at the end.

    Returns step(pixel_idx[lanes], spp_idx) with lanes % n_dev == 0.
    """

    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis), P()),
        out_specs=(P(axis), P(axis), P(axis)),
    )
    def step(pixel_idx, spp_idx):
        return render_pixels(pixel_idx, spp_idx)

    return step
