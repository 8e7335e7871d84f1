"""Built-in validation scenes.

The reference ships hand-authored glTF test scenes (cornelbox.gltf,
WhiteFurnanceTest, …; SURVEY.md §4) plus a hardcoded testGeometry() smoke
scene (renderer.h:942-978). These builders recreate the canonical ones in
code so the test suite needs no binary assets.
"""

from __future__ import annotations

import numpy as np

from henjou.scene.scenedata import (
    GeometryData,
    InstanceData,
    SceneData,
    make_material,
)


def _quad(p0, p1, p2, p3):
    """Two CCW triangles for the quad p0-p1-p2-p3."""
    return [p0, p1, p2, p0, p2, p3]


def _face_normal(a, b, c):
    n = np.cross(np.subtract(b, a), np.subtract(c, a))
    return n / (np.linalg.norm(n) + 1e-20)


def _build_tri_soup(tris_by_material):
    """tris_by_material: list of (vertex_list, material_id). De-indexed soup
    with face normals, sequential indices (gltfloader.h:1484-1492 style)."""
    verts, norms, mat_ids = [], [], []
    for vlist, mid in tris_by_material:
        for i in range(0, len(vlist), 3):
            a, b, c = vlist[i], vlist[i + 1], vlist[i + 2]
            n = _face_normal(a, b, c)
            verts.extend([a, b, c])
            norms.extend([n, n, n])
            mat_ids.append(mid)
    verts = np.asarray(verts, np.float32)
    norms = np.asarray(norms, np.float32)
    indices = np.arange(len(verts), dtype=np.uint32)
    return verts, norms, indices, np.asarray(mat_ids, np.uint32)


def cornell_box_scene(light_emission=10.0) -> SceneData:
    """Classic Cornell box in a 2x2x2 cube around the origin, area light in
    the ceiling — mirrors the reference's cornelbox.gltf test scene."""
    white = make_material("white", base_color=(0.8, 0.8, 0.8), roughness=1.0)
    red = make_material("red", base_color=(0.8, 0.05, 0.05), roughness=1.0)
    green = make_material("green", base_color=(0.05, 0.8, 0.05), roughness=1.0)
    light = make_material(
        "light",
        base_color=(1.0, 1.0, 1.0),
        emission=(light_emission,) * 3,
        is_light=True,
    )
    materials = [white, red, green, light]

    s = 1.0
    tris = []
    # floor (y=-1, normal +y)
    tris.append((_quad([-s, -s, -s], [-s, -s, s], [s, -s, s], [s, -s, -s]), 0))
    # ceiling (y=+1, normal -y)
    tris.append((_quad([-s, s, -s], [s, s, -s], [s, s, s], [-s, s, s]), 0))
    # back wall (z=+1, normal -z)
    tris.append((_quad([-s, -s, s], [-s, s, s], [s, s, s], [s, -s, s]), 0))
    # left wall (x=-1, normal +x) red
    tris.append((_quad([-s, -s, -s], [-s, s, -s], [-s, s, s], [-s, -s, s]), 1))
    # right wall (x=+1, normal -x) green
    tris.append((_quad([s, -s, -s], [s, -s, s], [s, s, s], [s, s, -s]), 2))
    # ceiling light (slightly below ceiling, normal -y)
    l = 0.4
    y = s - 1e-3
    tris.append((_quad([-l, y, -l], [l, y, -l], [l, y, l], [-l, y, l]), 3))

    verts, norms, indices, mat_ids = _build_tri_soup(tris)
    scene = SceneData(
        vertices=verts,
        indices=indices,
        material_ids=mat_ids,
        normals=norms,
        texcoords=None,
        colors=None,
        materials=materials,
        geometries=[GeometryData(0, len(indices))],
        instances=[InstanceData(0)],
    )
    return scene


def _uv_sphere(center, radius, lat=16, lon=32):
    """De-indexed UV sphere with smooth normals: (verts[N,3], normals[N,3])."""
    pts = []
    for i in range(lat + 1):
        th = np.pi * i / lat
        for j in range(lon):
            ph = 2 * np.pi * j / lon
            pts.append(
                [np.sin(th) * np.cos(ph), np.cos(th), np.sin(th) * np.sin(ph)]
            )
    pts = np.asarray(pts, np.float32)
    tris = []
    for i in range(lat):
        for j in range(lon):
            a = i * lon + j
            b = i * lon + (j + 1) % lon
            c = (i + 1) * lon + j
            d = (i + 1) * lon + (j + 1) % lon
            if i != 0:
                tris.append([a, b, c])
            if i != lat - 1:
                tris.append([b, d, c])
    tri_idx = np.asarray(tris, np.uint32)
    v_unit = pts[tri_idx.reshape(-1)]
    n = v_unit / np.linalg.norm(v_unit, axis=-1, keepdims=True)
    v = v_unit * radius + np.asarray(center, np.float32)
    return v.astype(np.float32), n.astype(np.float32)


def sphere_gallery_scene() -> SceneData:
    """BASELINE config #2: a row of spheres exercising every BSDF lobe —
    Disney diffuse, rough metal (multiple-scattering GGX), minus-IOR
    meta-glass, thin-film — over a floor with an area light."""
    mats = [
        make_material("floor", base_color=(0.7, 0.7, 0.7), roughness=0.9),
        make_material("disney", base_color=(0.7, 0.2, 0.2), roughness=0.35),
        make_material("metal", base_color=(0.9, 0.7, 0.3), roughness=0.3, metallic=1.0),
        make_material(
            "metaglass",
            base_color=(1.0, 1.0, 1.0),
            roughness=0.0,
            ior=1.5,
            transmission=1.0,
            ideal_specular=True,
        ),
        make_material(
            "thinfilm", base_color=(0.35, 0.35, 0.35), roughness=0.15, is_thinfilm=True
        ),
        make_material("light", emission=(20.0, 20.0, 20.0), is_light=True),
    ]

    verts_all, norms_all, mat_ids = [], [], []

    def add_tris(v, n, mid):
        verts_all.append(v)
        norms_all.append(n)
        mat_ids.extend([mid] * (len(v) // 3))

    # floor at y=-1
    s = 8.0
    floor = _quad([-s, -1.0, -s], [-s, -1.0, s], [s, -1.0, s], [s, -1.0, -s])
    fv = np.asarray(floor, np.float32)
    fn = np.tile(np.asarray([[0.0, 1.0, 0.0]], np.float32), (len(fv), 1))
    add_tris(fv, fn, 0)

    # sphere row
    for k, mid in enumerate((1, 2, 3, 4)):
        v, n = _uv_sphere(((k - 1.5) * 2.2, 0.0, 0.0), 1.0)
        add_tris(v, n, mid)

    # area light overhead (facing down)
    l = 3.0
    y = 6.0
    lv = np.asarray(
        _quad([-l, y, -l], [l, y, -l], [l, y, l], [-l, y, l]), np.float32
    )
    ln = np.tile(np.asarray([[0.0, -1.0, 0.0]], np.float32), (len(lv), 1))
    add_tris(lv, ln, 5)

    verts = np.concatenate(verts_all)
    norms = np.concatenate(norms_all)
    indices = np.arange(len(verts), dtype=np.uint32)
    return SceneData(
        vertices=verts,
        indices=indices,
        material_ids=np.asarray(mat_ids, np.uint32),
        normals=norms,
        texcoords=None,
        colors=None,
        materials=mats,
    )


def furnace_scene(albedo=1.0, roughness=0.5, metallic=1.0) -> SceneData:
    """White-furnace test: a UV sphere in empty space; the runtime supplies a
    constant sky. With a perfectly energy-conserving BSDF the sphere must
    disappear (reference: WhiteFurnanceTest scenes, SURVEY.md §4)."""
    mat = make_material(
        "furnace",
        base_color=(albedo,) * 3,
        roughness=roughness,
        metallic=metallic,
    )
    lat, lon = 16, 32
    verts = []
    for i in range(lat + 1):
        th = np.pi * i / lat
        for j in range(lon):
            ph = 2 * np.pi * j / lon
            verts.append(
                [np.sin(th) * np.cos(ph), np.cos(th), np.sin(th) * np.sin(ph)]
            )
    verts = np.asarray(verts, np.float32)

    tris = []
    for i in range(lat):
        for j in range(lon):
            a = i * lon + j
            b = i * lon + (j + 1) % lon
            c = (i + 1) * lon + j
            d = (i + 1) * lon + (j + 1) % lon
            if i != 0:
                tris.append([a, b, c])
            if i != lat - 1:
                tris.append([b, d, c])
    tri_idx = np.asarray(tris, np.uint32)

    # de-index with smooth (spherical) normals
    v = verts[tri_idx.reshape(-1)]
    n = v / np.linalg.norm(v, axis=-1, keepdims=True)
    indices = np.arange(len(v), dtype=np.uint32)
    return SceneData(
        vertices=v,
        indices=indices,
        material_ids=np.zeros(len(tri_idx), np.uint32),
        normals=n.astype(np.float32),
        texcoords=None,
        colors=None,
        materials=[mat],
    )


def thinfilm_sweep_scene(n_spheres: int = 8) -> SceneData:
    """BASELINE config #3: spheres sweeping thin-film thickness over a
    glossy floor. Thickness rides basecolor.x exactly as the reference's
    LUT lookup consumes it (disneyBRDF.h:213-218: lut(thickness =
    basecolor.x, cos_theta) -> F0), so the sweep renders the full
    iridescence ramp in one frame."""
    mats = [
        make_material("floor", base_color=(0.35, 0.35, 0.38), roughness=0.25),
        make_material("light", emission=(14.0, 14.0, 14.0), is_light=True),
    ]
    for k in range(n_spheres):
        thickness = (k + 0.5) / n_spheres
        mats.append(
            make_material(
                f"film{k}",
                base_color=(thickness, 0.25, 0.25),
                roughness=0.08,
                is_thinfilm=True,
            )
        )

    verts_all, norms_all, mat_ids = [], [], []

    def add_tris(v, n, mid):
        verts_all.append(v)
        norms_all.append(n)
        mat_ids.extend([mid] * (len(v) // 3))

    s = 14.0
    floor = _quad([-s, -1.0, -s], [-s, -1.0, s], [s, -1.0, s], [s, -1.0, -s])
    fv = np.asarray(floor, np.float32)
    fn = np.tile(np.asarray([[0.0, 1.0, 0.0]], np.float32), (len(fv), 1))
    add_tris(fv, fn, 0)

    for k in range(n_spheres):
        x = (k - (n_spheres - 1) / 2.0) * 2.3
        v, n = _uv_sphere((x, 0.0, 0.0), 1.0, lat=24, lon=48)
        add_tris(v, n, 2 + k)

    l = 4.0
    y = 6.5
    lv = np.asarray(
        _quad([-l, y, -l], [l, y, -l], [l, y, l], [-l, y, l]), np.float32
    )
    ln = np.tile(np.asarray([[0.0, -1.0, 0.0]], np.float32), (len(lv), 1))
    add_tris(lv, ln, 1)

    verts = np.concatenate(verts_all)
    norms = np.concatenate(norms_all)
    return SceneData(
        vertices=verts,
        indices=np.arange(len(verts), dtype=np.uint32),
        material_ids=np.asarray(mat_ids, np.uint32),
        normals=norms,
        texcoords=None,
        colors=None,
        materials=mats,
    )


def rtcamp_scene(grid: int = 8, lat: int = 32, lon: int = 64) -> SceneData:
    """BASELINE config #5: the contest-class scene — an exhibition hall of
    grid x grid pedestals each carrying a high-tessellation sphere, with
    every headline material in play (thin-film, minus-IOR meta-glass,
    multiple-scattering metal, Disney dielectrics), a CHECKERED textured
    floor, and an array of emissive ceiling panels (mesh lights).
    grid=8, lat=32, lon=64 -> ~256k triangles. The camera is animated by
    the caller (make_scenes emits an orbit; renderer.h:1149-1169 path).

    Texcoords: floor maps world xz -> [0,8] tiling; everything else 0."""
    import numpy as _np

    # texture 0 = checkerboard (attached by make_scenes / caller via
    # scene.textures; base_color_tex=0)
    mats = [
        make_material(
            "floor", base_color=(1.0, 1.0, 1.0), roughness=0.4,
            base_color_tex=0,
        ),
        make_material("pedestal", base_color=(0.25, 0.25, 0.28), roughness=0.6),
        make_material("light", emission=(16.0, 15.2, 13.6), is_light=True),
    ]
    kinds = []
    rng = _np.random.default_rng(9)
    for k in range(grid * grid):
        kind = k % 4
        kinds.append(kind)
        if kind == 0:  # Disney dielectric, varied hue/roughness
            hue = rng.uniform(0, 1, 3) * 0.6 + 0.2
            mats.append(
                make_material(
                    f"disney{k}", base_color=tuple(hue),
                    roughness=float(rng.uniform(0.1, 0.7)),
                )
            )
        elif kind == 1:  # multiple-scattering metal
            mats.append(
                make_material(
                    f"metal{k}",
                    base_color=(0.95, 0.78, 0.4) if k % 8 < 4 else (0.8, 0.8, 0.85),
                    roughness=float(rng.uniform(0.15, 0.5)),
                    metallic=1.0,
                )
            )
        elif kind == 2:  # minus-IOR meta-glass (headline #2, BSDFs.h:453-455)
            mats.append(
                make_material(
                    f"metaglass{k}", base_color=(1.0, 1.0, 1.0),
                    roughness=0.0, ior=1.5, transmission=1.0,
                    ideal_specular=True,
                )
            )
        else:  # thin-film (headline #1, disneyBRDF.h:213-218)
            mats.append(
                make_material(
                    f"film{k}",
                    base_color=(float(rng.uniform(0.1, 0.9)), 0.3, 0.3),
                    roughness=0.1,
                    is_thinfilm=True,
                )
            )

    verts_all, norms_all, tc_all, mat_ids = [], [], [], []

    def add_tris(v, n, mid, tc=None):
        verts_all.append(v)
        norms_all.append(n)
        tc_all.append(
            tc if tc is not None else _np.zeros((len(v), 2), _np.float32)
        )
        mat_ids.extend([mid] * (len(v) // 3))

    half = grid * 1.6
    floor = _quad(
        [-half, 0.0, -half], [-half, 0.0, half], [half, 0.0, half], [half, 0.0, -half]
    )
    fv = _np.asarray(floor, _np.float32)
    fn = _np.tile(_np.asarray([[0.0, 1.0, 0.0]], _np.float32), (len(fv), 1))
    ftc = (fv[:, [0, 2]] / (2 * half) + 0.5) * 8.0  # 8x8 checker tiling
    add_tris(fv, fn, 0, ftc.astype(_np.float32))

    def add_box(center, size, mid):
        cx, cy, cz = center
        sx, sy, sz = size
        lo = _np.asarray([cx - sx, cy - sy, cz - sz], _np.float32)
        hi = _np.asarray([cx + sx, cy + sy, cz + sz], _np.float32)
        faces = [
            ([lo[0], lo[1], lo[2]], [lo[0], hi[1], lo[2]], [hi[0], hi[1], lo[2]], [hi[0], lo[1], lo[2]], [0, 0, -1]),
            ([lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]], [hi[0], hi[1], hi[2]], [lo[0], hi[1], hi[2]], [0, 0, 1]),
            ([lo[0], lo[1], lo[2]], [lo[0], lo[1], hi[2]], [lo[0], hi[1], hi[2]], [lo[0], hi[1], lo[2]], [-1, 0, 0]),
            ([hi[0], lo[1], lo[2]], [hi[0], hi[1], lo[2]], [hi[0], hi[1], hi[2]], [hi[0], lo[1], hi[2]], [1, 0, 0]),
            ([lo[0], hi[1], lo[2]], [lo[0], hi[1], hi[2]], [hi[0], hi[1], hi[2]], [hi[0], hi[1], lo[2]], [0, 1, 0]),
            ([lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]], [hi[0], lo[1], hi[2]], [lo[0], lo[1], hi[2]], [0, -1, 0]),
        ]
        for p0, p1, p2, p3, nrm in faces:
            q = _np.asarray(_quad(p0, p1, p2, p3), _np.float32)
            qn = _np.tile(_np.asarray([nrm], _np.float32), (len(q), 1))
            add_tris(q, qn, mid)

    spacing = 2 * half / grid
    for gy in range(grid):
        for gx in range(grid):
            k = gy * grid + gx
            cx = -half + (gx + 0.5) * spacing
            cz = -half + (gy + 0.5) * spacing
            add_box((cx, 0.3, cz), (0.45, 0.3, 0.45), 1)
            v, n = _uv_sphere((cx, 1.05, cz), 0.42, lat=lat, lon=lon)
            add_tris(v, n, 3 + k)

    # ceiling light panels (mesh lights: many emissive tris)
    y = 7.0
    for lx in range(3):
        for lz in range(3):
            cx = (lx - 1) * half * 0.6
            cz = (lz - 1) * half * 0.6
            l = half * 0.12
            lv = _np.asarray(
                _quad([cx - l, y, cz - l], [cx + l, y, cz - l],
                      [cx + l, y, cz + l], [cx - l, y, cz + l]),
                _np.float32,
            )
            ln = _np.tile(_np.asarray([[0.0, -1.0, 0.0]], _np.float32), (len(lv), 1))
            add_tris(lv, ln, 2)

    verts = _np.concatenate(verts_all)
    norms = _np.concatenate(norms_all)
    tcs = _np.concatenate(tc_all)
    return SceneData(
        vertices=verts,
        indices=_np.arange(len(verts), dtype=_np.uint32),
        material_ids=_np.asarray(mat_ids, _np.uint32),
        normals=norms,
        texcoords=tcs,
        colors=None,
        materials=mats,
    )


def headline_mini_scene() -> SceneData:
    """Compact scene exercising BOTH headline reference features in one
    frame for the fast-lane goldens (round-3 VERDICT ask #4): a
    thin-film thickness pair (disneyBRDF.h:213-218 LUT path), a
    minus-IOR meta-glass sphere (BSDFs.h:453-455 headline), a
    multiple-scattering metal, over a diffuse floor with a mesh light.
    Low tessellation (~1.3k tris) so a CPU masked render of a 96x54
    golden stays in the fast test lane."""
    mats = [
        make_material("floor", base_color=(0.45, 0.45, 0.48), roughness=0.5),
        make_material("light", emission=(15.0, 14.2, 12.8), is_light=True),
        make_material(
            "film_a", base_color=(0.2, 0.3, 0.3), roughness=0.08,
            is_thinfilm=True,
        ),
        make_material(
            "film_b", base_color=(0.75, 0.3, 0.3), roughness=0.08,
            is_thinfilm=True,
        ),
        make_material(
            "metaglass", base_color=(1.0, 1.0, 1.0), roughness=0.0,
            ior=1.5, transmission=1.0, ideal_specular=True,
        ),
        make_material(
            "metal", base_color=(0.95, 0.78, 0.4), roughness=0.25,
            metallic=1.0,
        ),
    ]
    verts_all, norms_all, mat_ids = [], [], []

    def add_tris(v, n, mid):
        verts_all.append(np.asarray(v, np.float32))
        norms_all.append(np.asarray(n, np.float32))
        mat_ids.extend([mid] * (len(v) // 3))

    s = 8.0
    fv = np.asarray(
        _quad([-s, -1.0, -s], [-s, -1.0, s], [s, -1.0, s], [s, -1.0, -s]),
        np.float32,
    )
    fn = np.tile(np.asarray([[0.0, 1.0, 0.0]], np.float32), (len(fv), 1))
    add_tris(fv, fn, 0)

    for i, mid in enumerate((2, 3, 4, 5)):
        x = (i - 1.5) * 2.2
        v, n = _uv_sphere((x, 0.0, 0.0), 1.0, lat=10, lon=20)
        add_tris(v, n, mid)

    l = 3.0
    y = 5.5
    lv = np.asarray(
        _quad([-l, y, -l], [l, y, -l], [l, y, l], [-l, y, l]), np.float32
    )
    ln = np.tile(np.asarray([[0.0, -1.0, 0.0]], np.float32), (len(lv), 1))
    add_tris(lv, ln, 1)

    verts = np.concatenate(verts_all)
    norms = np.concatenate(norms_all)
    return SceneData(
        vertices=verts,
        indices=np.arange(len(verts), dtype=np.uint32),
        material_ids=np.asarray(mat_ids, np.uint32),
        normals=norms,
        texcoords=None,
        colors=None,
        materials=mats,
    )
