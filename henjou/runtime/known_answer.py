"""Known-answer render: a tiny film pinned in `tests/golden/`.

A 16x16 MIS render of the sphere gallery (4 spp, seed 11, depth 4) through
the wavefront engine, the jitted LBVH build and the backend's route
(accel/route.py). Every pixel of the result is compared with the pinned
film, so a wrong kernel, a wrong build or a wrong argument-passing jit on
a backend fails loudly. The pinned film was rendered on the CPU.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

PINNED_FILM = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "tests", "golden", "known_answer_film.npy",
)
RMSE_TOL = 5e-3
SPP = 4


def render_known_answer_film() -> np.ndarray:
    """The [256, 3] mean-color film on the default backend."""
    from henjou.accel.lbvh import build_lbvh
    from henjou.accel.route import make_intersectors
    from henjou.bsdf.dispatch import bsdf_eval, bsdf_pdf, make_bsdf_sampler
    from henjou.integrator.payload import Sky
    from henjou.integrator.wavefront import wavefront_render
    from henjou.runtime.camera import make_camera
    from henjou.scene.scenedata import build_device_scene, build_frame_scene
    from henjou.scene.testscenes import sphere_gallery_scene

    dev = build_device_scene(sphere_gallery_scene())
    frame = jax.jit(build_frame_scene)(dev, None, None)
    bvh = jax.jit(build_lbvh)(frame.tri_verts)
    sky = Sky(
        constant_color=jnp.asarray([0.3, 0.4, 0.55]), intensity=jnp.asarray(1.0)
    )
    cam = make_camera((0.0, 1.2, -9.0), (0.0, -0.05, 1.0), np.radians(45.0))
    bs = make_bsdf_sampler(None)

    def beval(h, wo, wi):
        return bsdf_eval(h, wo, wi, None)

    @jax.jit
    def render(frame, bvh, cam):
        ifn, ofn = make_intersectors(bvh)
        return wavefront_render(
            frame, sky, cam, 16, 16, SPP, bs, bsdf_eval=beval,
            bsdf_pdf=bsdf_pdf, integrator="mis", seed=11, lanes=1024,
            max_depth=4, intersect_fn=ifn, occluded_fn=ofn,
        )

    film = render(frame, bvh, cam)
    return np.asarray(film.color) / SPP


def known_answer_rmse(film: np.ndarray) -> float:
    """Per-pixel RMSE of `film` against the pinned film."""
    pinned = np.load(PINNED_FILM)
    return float(np.sqrt(np.mean((film - pinned) ** 2)))
