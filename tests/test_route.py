"""Backend routes (accel/route.py): one place decides the engine and the
traversal, with no Pallas and no interpret mode anywhere."""

import os
import re

import jax
import numpy as np
import pytest

from henjou.accel import cuda_traverse, route, traverse
from henjou.accel.lbvh import build_lbvh

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "henjou")


@pytest.mark.parametrize(
    "platform, engine, traversal",
    [("cpu", "masked", "xla"), ("gpu", "wavefront", "cuda")],
)
def test_route_for_backend(platform, engine, traversal):
    r = route.route_for(platform)
    assert (r.platform, r.engine, r.traversal) == (platform, engine, traversal)


def test_default_route_is_the_default_backend():
    assert route.route_for() == route.route_for(jax.default_backend())


def test_unknown_backend_is_an_error():
    with pytest.raises(RuntimeError, match="no render route"):
        route.route_for("rocm")


def _tiny_bvh():
    rng = np.random.default_rng(0)
    c = rng.uniform(-2, 2, (300, 1, 3))
    return build_lbvh(jax.numpy.asarray((c + rng.normal(scale=0.2, size=(300, 3, 3))).astype(np.float32)))


@pytest.mark.parametrize(
    "platform, module", [("cpu", traverse), ("gpu", cuda_traverse)]
)
def test_route_picks_the_intersector(platform, module):
    ifn, ofn = route.make_intersectors(_tiny_bvh(), route.route_for(platform))
    assert ifn.__module__ == module.__name__
    assert ofn.__module__ == module.__name__


def test_package_has_no_pallas_and_no_interpret_mode():
    hits = []
    for root, _, files in os.walk(PKG):
        for name in files:
            if name.endswith((".py", ".cu")):
                path = os.path.join(root, name)
                with open(path) as f:
                    for i, line in enumerate(f, 1):
                        if re.search(r"pallas|interpret\s*=", line):
                            hits.append(f"{path}:{i}: {line.strip()}")
    assert not hits, hits


def test_renderer_accel_threshold():
    """Scenes of at most BRUTE_FORCE_MAX_TRIS triangles get no accel."""
    from henjou.runtime.renderer import Renderer
    from henjou.scene.scenedata import build_device_scene, build_frame_scene
    from henjou.scene.testscenes import cornell_box_scene, sphere_gallery_scene

    r = Renderer()
    for scene, want_accel in ((cornell_box_scene(), False), (sphere_gallery_scene(), True)):
        r.set_scene(scene).build()
        frame = build_frame_scene(build_device_scene(scene))
        n = int(frame.tri_verts.shape[0])
        accel = r._build_accel(frame)
        assert (accel is not None) == want_accel == (n > route.BRUTE_FORCE_MAX_TRIS)
        if accel is not None:
            assert accel.num_tris == n
