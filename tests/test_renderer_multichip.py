"""Production multi-chip rendering: Renderer.render_frame spp-shards its
chunk steps over every visible device (Henjou.multichip="auto") and must
produce the same image as the single-device run (VERDICT r4 #4; the
reference's one launch renderer.h:1241 is single-GPU — this is the mesh
replacement, SURVEY.md §2.5/§7 M8). Runs on the virtual 8-device CPU
mesh from conftest."""

import jax
import numpy as np
import pytest

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)


def _render(multichip: str):
    from henjou.runtime.options import RenderOption
    from henjou.runtime.renderer import Renderer
    from henjou.scene.testscenes import sphere_gallery_scene

    opt = RenderOption(
        image_width=16, image_height=16, max_spp=8, spp_batch=1,
        engine="wavefront", multichip=multichip,
        scene_sky_default=(0.3, 0.4, 0.55),
        camera_position=(0.0, 1.2, -9.0),
        camera_direction=(0.0, -0.05, 1.0),
        camera_fov=float(np.radians(45.0)),
    )
    r = Renderer(option=opt)
    r.set_scene(sphere_gallery_scene())
    r.build()
    return r.render_frame(0)


def test_sharded_render_frame_matches_single_device():
    """8 spp as ONE sharded step (sample index k on device k, films psum
    over the mesh) vs 8 sequential single-device 1-spp batches: same
    sample set, so the images agree to summation-order rounding."""
    sh = _render("auto")
    ref = _render("off")
    assert sh["spp_done"] == 8 and ref["spp_done"] == 8
    assert (sh["count"] == 8).all() and (ref["count"] == 8).all()
    np.testing.assert_allclose(sh["color"], ref["color"], rtol=3e-5, atol=1e-6)
    np.testing.assert_allclose(sh["albedo"], ref["albedo"], rtol=3e-5, atol=1e-6)
    np.testing.assert_allclose(sh["normal"], ref["normal"], rtol=3e-5, atol=1e-6)
