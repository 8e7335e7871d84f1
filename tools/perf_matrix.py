"""Scene-scale timing through the renderer's own path.

    python tools/perf_matrix.py [gallery|scale|million] [spp]

Renders one frame of MIS through `Renderer.render_frame` (wavefront
engine, the backend's route) twice — the first compiles — and prints the
scene size, the second frame's render time and the traced rays per
second. `million` is the generated ~1M-triangle regime (`big_scene`):
a lat x lon UV sphere over a ground plane with one area light.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from henjou.runtime.compile_cache import enable_compile_cache  # noqa: E402


def big_scene(lat=232, lon=420):
    """UV sphere of about 2*lat*lon triangles over a ground plane, plus a
    quad area light; 3 materials (lat=527, lon=950: 999,404 triangles)."""
    from henjou.scene.scenedata import SceneData, make_material

    th = np.pi * np.arange(lat + 1) / lat
    ph = 2 * np.pi * np.arange(lon) / lon
    st, ct = np.sin(th)[:, None], np.cos(th)[:, None]
    verts = np.stack(
        [st * np.cos(ph), np.broadcast_to(ct + 1.2, (lat + 1, lon)), st * np.sin(ph)],
        axis=-1,
    ).reshape(-1, 3).astype(np.float32)
    i, j = np.meshgrid(np.arange(lat), np.arange(lon), indexing="ij")
    a, b = i * lon + j, i * lon + (j + 1) % lon
    c, d = (i + 1) * lon + j, (i + 1) * lon + (j + 1) % lon
    upper = np.stack([a, b, c], -1)[1:].reshape(-1, 3)  # skip the top pole row
    lower = np.stack([b, d, c], -1)[:-1].reshape(-1, 3)  # skip the bottom row
    faces = np.concatenate([upper, lower]).astype(np.uint32)

    base = len(verts)
    plane = np.asarray([[-8, 0, -8], [8, 0, -8], [8, 0, 8], [-8, 0, 8]], np.float32)
    light = np.asarray([[-2, 6, -2], [2, 6, -2], [2, 6, 2], [-2, 6, 2]], np.float32)
    verts = np.concatenate([verts, plane, light])
    extra = np.asarray(
        [(base, base + 1, base + 2), (base, base + 2, base + 3),
         (base + 4, base + 6, base + 5), (base + 4, base + 7, base + 6)],
        np.uint32,
    )
    tri = np.concatenate([faces, extra])
    flat = verts[tri.reshape(-1)]
    t3 = flat.reshape(-1, 3, 3)
    fn = np.cross(t3[:, 1] - t3[:, 0], t3[:, 2] - t3[:, 0])
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
    mats = [
        make_material("metal", base_color=(0.9, 0.7, 0.4), metallic=1.0, roughness=0.25),
        make_material("floor", base_color=(0.6, 0.6, 0.65), roughness=0.8),
        make_material("light", emission=(12.0, 12.0, 12.0), is_light=True),
    ]
    mat_ids = np.concatenate(
        [np.zeros(len(faces), np.uint32), np.ones(2, np.uint32), np.full(2, 2, np.uint32)]
    )
    return SceneData(
        vertices=flat,
        indices=np.arange(len(flat), dtype=np.uint32),
        material_ids=mat_ids,
        normals=np.repeat(fn[:, None, :], 3, axis=1).reshape(-1, 3),
        texcoords=None,
        colors=None,
        materials=mats,
    )


def scene_and_view(which: str):
    from henjou.scene.testscenes import rtcamp_scene, sphere_gallery_scene

    if which == "gallery":
        return sphere_gallery_scene(), 512, 512, (0.0, 1.2, -9.0), (0.0, -0.05, 1.0), 45.0
    if which == "million":
        return big_scene(lat=527, lon=950), 1920, 1080, (0.0, 2.0, -6.0), (0.0, -0.1, 1.0), 45.0
    return rtcamp_scene(), 1920, 1080, (0.0, 6.0, -16.5), (0.0, -0.28, 1.0), 40.0


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else "gallery"
    spp = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    enable_compile_cache()
    import jax

    from henjou.runtime.options import RenderOption
    from henjou.runtime.renderer import Renderer

    scene, w, h, pos, direction, fov = scene_and_view(which)
    r = Renderer(option=RenderOption(
        image_width=w, image_height=h, max_spp=spp, engine="wavefront",
        scene_sky_default=(0.3, 0.4, 0.55), camera_position=pos,
        camera_direction=direction, camera_fov=float(np.radians(fov)),
    ))
    r.set_scene(scene)
    r.build()
    r.render_frame(0)  # compile
    t0 = time.perf_counter()
    aovs = r.render_frame(0)
    wall = time.perf_counter() - t0
    dev = jax.devices()[0]
    print(
        f"scene={which} tris={len(scene.material_ids)} {w}x{h} spp={aovs['spp_done']} "
        f"frame {wall:.3f} s, {aovs['n_traces'] / aovs['render_s'] / 1e6:.1f} Mrays/s "
        f"on {dev.device_kind} x{len(jax.devices())}"
    )


if __name__ == "__main__":
    main()
