"""Benchmark rows through the renderer's own path (`Renderer.render_frame`).

Prints one JSON line per row; every line names the device it ran on
(JAX platform, device kind and count, and on a GPU the card's name and
power limit as `nvidia-smi` reports them). Rays are counted like the
reference's operating envelope (SURVEY.md §6): every closest-hit or shadow
trace is one ray, as the wavefront engine counts them.

Rows:
  gallery_mis_ref      sphere gallery 512x512, two-sample MIS, 16 spp
  gallery_mis_single   the same under one-sample MIS (the product default)
  contest720_single    the contest scene at 1280x720, one-sample MIS, 16 spp
  contest720_60s_rmse  a 60 s render of the contest scene, SVGF-denoised,
                       RMSE against tests/golden/gt_rtcamp720.npz

Each row renders once to compile, then once timed.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from henjou.runtime.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax  # noqa: E402
import numpy as np  # noqa: E402


def device_info() -> dict:
    dev = jax.devices()[0]
    info = {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}
    if dev.platform == "gpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        )
        info["nvidia_smi"] = smi.stdout.strip().splitlines()[0].strip()
    return info


def _renderer(scene, **opts):
    from henjou.runtime.options import RenderOption
    from henjou.runtime.renderer import Renderer

    r = Renderer(option=RenderOption(engine="wavefront", **opts))
    r.set_scene(scene)
    r.build()
    return r


def throughput_row(name, scene, **opts):
    r = _renderer(scene, **opts)
    r.render_frame(0)  # compile
    t0 = time.perf_counter()
    aovs = r.render_frame(0)
    return {
        "metric": name,
        "spp": aovs["spp_done"],
        "frame_s": time.perf_counter() - t0,
        "mrays_per_s": aovs["n_traces"] / aovs["render_s"] / 1e6,
    }


def quality_row(budget_s=60.0):
    from henjou.post.denoise import denoise_atrous_var
    from henjou.scene.testscenes import rtcamp_scene

    gt = np.load(os.path.join(HERE, "tests", "golden", "gt_rtcamp720.npz"))["color"]
    r = _renderer(
        rtcamp_scene(), image_width=1280, image_height=720, max_spp=100000,
        firefly_clamp=64.0, scene_sky_default=(0.35, 0.45, 0.62),
        camera_position=(0.0, 6.0, -16.5), camera_direction=(0.0, -0.28, 1.0),
        camera_fov=float(np.radians(40.0)),
    )
    r.render_frame(0, deadline=0.5)  # compile and calibrate the scheduler
    t0 = time.perf_counter()
    aovs = r.render_frame(0, deadline=budget_s)
    wall = time.perf_counter() - t0
    den = np.asarray(denoise_atrous_var(
        aovs["color"], aovs["albedo"], aovs["normal"], aovs["variance"],
        demodulate=True,
    ))
    return {
        "metric": "contest720_60s_rmse",
        "spp": aovs["spp_done"],
        "frame_s": wall,
        "rmse_raw": float(np.sqrt(np.mean((aovs["color"] - gt) ** 2))),
        "rmse_svgf": float(np.sqrt(np.mean((den - gt) ** 2))),
    }


def main():
    from henjou.scene.testscenes import rtcamp_scene, sphere_gallery_scene

    device = device_info()
    gallery = dict(
        image_width=512, image_height=512, max_spp=16,
        scene_sky_default=(0.3, 0.4, 0.55), camera_position=(0.0, 1.2, -9.0),
        camera_direction=(0.0, -0.05, 1.0), camera_fov=float(np.radians(45.0)),
    )
    rows = [
        lambda: throughput_row("gallery_mis_ref", sphere_gallery_scene(), mis_mode="ref", **gallery),
        lambda: throughput_row("gallery_mis_single", sphere_gallery_scene(), **gallery),
        lambda: throughput_row(
            "contest720_single", rtcamp_scene(), image_width=1280, image_height=720,
            max_spp=16, scene_sky_default=(0.35, 0.45, 0.62),
            camera_position=(0.0, 6.0, -16.5), camera_direction=(0.0, -0.28, 1.0),
            camera_fov=float(np.radians(40.0)),
        ),
        quality_row,
    ]
    for row in rows:
        print(json.dumps(dict(row(), device=device)), flush=True)


if __name__ == "__main__":
    main()
