"""The render route of each JAX backend, decided here and nowhere else.

A route says which integration engine `engine="auto"` resolves to and
which LBVH traversal traces rays. Scenes of at most `BRUTE_FORCE_MAX_TRIS`
triangles need no acceleration structure on any backend.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax

BRUTE_FORCE_MAX_TRIS = 256


@dataclasses.dataclass(frozen=True)
class Route:
    platform: str
    engine: str  # what RenderOption.engine="auto" resolves to
    traversal: str  # "cuda": accel/cuda_traverse.py, "xla": accel/traverse.py


ROUTES = {
    "gpu": Route(platform="gpu", engine="wavefront", traversal="cuda"),
    "cpu": Route(platform="cpu", engine="masked", traversal="xla"),
}


def route_for(platform: Optional[str] = None) -> Route:
    """Route of `platform` (default: JAX's default backend)."""
    platform = platform or jax.default_backend()
    if platform not in ROUTES:
        raise RuntimeError(
            f"no render route for JAX backend {platform!r} "
            f"(routes exist for {sorted(ROUTES)})"
        )
    return ROUTES[platform]


def make_intersectors(bvh, route: Optional[Route] = None):
    """(intersect_fn, occluded_fn) over `bvh` for the route's traversal."""
    route = route or route_for()
    if route.traversal == "cuda":
        from henjou.accel.cuda_traverse import make_cuda_intersector

        return make_cuda_intersector(bvh)
    from henjou.accel.traverse import make_bvh_intersector

    return make_bvh_intersector(bvh)
