"""CLI entry: ``python -m henjou.render <render_option.json>``.

The reference's absent trivial main (henjouRenderer.cpp) called
Renderer::initializeAndRender(json_path); this is the same surface. With no
argument it renders the built-in Cornell smoke scene (testGeometry
analogue, renderer.h:942-978).
"""

from __future__ import annotations

import argparse
import logging
import sys


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO, format="[%(levelname).1s] %(name)s: %(message)s"
    )
    ap = argparse.ArgumentParser(description="Henjou renderer")
    ap.add_argument("option", nargs="?", help="render_option.json path")
    ap.add_argument("--spp", type=int, help="override max_spp")
    ap.add_argument("--size", type=str, help="override WxH, e.g. 512x512")
    ap.add_argument("--out", type=str, help="override image_name")
    ap.add_argument(
        "--profile",
        type=str,
        metavar="DIR",
        help="capture a jax.profiler trace of the render into DIR "
        "(view with TensorBoard / Perfetto)",
    )
    ap.add_argument(
        "--debug-nans",
        action="store_true",
        help="enable jax_debug_nans (fail fast on NaN in any kernel)",
    )
    args = ap.parse_args(argv)

    from henjou.runtime.compile_cache import enable_compile_cache

    enable_compile_cache()

    if args.debug_nans:
        import jax

        jax.config.update("jax_debug_nans", True)

    import dataclasses

    from henjou.runtime.renderer import Renderer

    r = Renderer()
    if args.option:
        r.load_render_option(args.option)
        r._load_scene_from_option()
    else:
        from henjou.runtime.options import RenderOption
        from henjou.scene.testscenes import cornell_box_scene

        r.option = RenderOption(
            image_width=256,
            image_height=256,
            image_name="cornell",
            max_spp=64,
            camera_position=(0.0, 0.0, -4.5),
            camera_direction=(0.0, 0.0, 1.0),
            scene_sky_default=(0.0, 0.0, 0.0),
            time_limit=10.0,
        )
        r.set_scene(cornell_box_scene())
        r.build()

    overrides = {}
    if args.spp:
        overrides["max_spp"] = args.spp
    if args.size:
        w, h = args.size.lower().split("x")
        overrides["image_width"] = int(w)
        overrides["image_height"] = int(h)
    if args.out:
        overrides["image_name"] = args.out
    if overrides:
        r.option = dataclasses.replace(r.option, **overrides)

    if args.profile:
        import jax

        with jax.profiler.trace(args.profile):
            written = r.initialize_and_render()
        print("profile trace written to", args.profile)
    else:
        written = r.initialize_and_render()
    print("wrote:", ", ".join(written))
    return 0


if __name__ == "__main__":
    sys.exit(main())
