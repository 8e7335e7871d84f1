"""glTF / OBJ loader tests with hand-crafted assets (SURVEY.md §7 M5)."""

import base64
import json
import struct

import numpy as np
import pytest

from henjou.scene.gltf import load_gltf
from henjou.scene.obj import load_obj
from henjou.scene.scenedata import build_device_scene


def _gltf_doc():
    # one quad (2 tris, 4 verts indexed) + an animated node + a camera node
    positions = np.asarray(
        [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32
    )
    normals = np.asarray([[0, 0, 1]] * 4, np.float32)
    indices = np.asarray([0, 1, 2, 0, 2, 3], np.uint16)
    anim_keys = np.asarray([0.0, 1.0], np.float32)
    anim_vals = np.asarray([[0, 0, 0], [2, 0, 0]], np.float32)

    blob = b"".join(
        [
            positions.tobytes(),
            normals.tobytes(),
            indices.tobytes(),
            b"\x00\x00",  # pad to 4
            anim_keys.tobytes(),
            anim_vals.tobytes(),
        ]
    )
    off_pos = 0
    off_nrm = off_pos + positions.nbytes
    off_idx = off_nrm + normals.nbytes
    off_keys = off_idx + indices.nbytes + 2
    off_vals = off_keys + anim_keys.nbytes

    doc = {
        "asset": {"version": "2.0"},
        "buffers": [
            {
                "byteLength": len(blob),
                "uri": "data:application/octet-stream;base64,"
                + base64.b64encode(blob).decode(),
            }
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": off_pos, "byteLength": positions.nbytes},
            {"buffer": 0, "byteOffset": off_nrm, "byteLength": normals.nbytes},
            {"buffer": 0, "byteOffset": off_idx, "byteLength": indices.nbytes},
            {"buffer": 0, "byteOffset": off_keys, "byteLength": anim_keys.nbytes},
            {"buffer": 0, "byteOffset": off_vals, "byteLength": anim_vals.nbytes},
        ],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 4, "type": "VEC3"},
            {"bufferView": 2, "componentType": 5123, "count": 6, "type": "SCALAR"},
            {"bufferView": 3, "componentType": 5126, "count": 2, "type": "SCALAR"},
            {"bufferView": 4, "componentType": 5126, "count": 2, "type": "VEC3"},
        ],
        "meshes": [
            {
                "primitives": [
                    {"attributes": {"POSITION": 0, "NORMAL": 1}, "indices": 2, "material": 0}
                ]
            }
        ],
        "materials": [
            {
                "name": "testmat",
                "pbrMetallicRoughness": {
                    "baseColorFactor": [0.5, 0.25, 0.125, 1.0],
                    "roughnessFactor": 0.0,
                    "metallicFactor": 0.75,
                },
                "emissiveFactor": [1.0, 1.0, 1.0],
                "extensions": {
                    "KHR_materials_emissive_strength": {"emissiveStrength": 5.0},
                    "KHR_materials_transmission": {"transmissionFactor": 1.0},
                    "KHR_materials_ior": {"ior": 1.6},
                    "KHR_materials_clearcoat": {"clearcoatFactor": 0.4},
                    "KHR_materials_sheen": {"sheenRoughnessFactor": 0.3},
                    "ThinFilm": {"is_ThinFilm": True},
                },
            }
        ],
        "nodes": [
            {"mesh": 0, "translation": [1, 2, 3]},
            {"camera": 0},
        ],
        "cameras": [{"type": "perspective", "perspective": {"yfov": 0.9}}],
        "animations": [
            {
                "samplers": [{"input": 3, "output": 4, "interpolation": "LINEAR"}],
                "channels": [
                    {"sampler": 0, "target": {"node": 0, "path": "translation"}}
                ],
            }
        ],
        "scenes": [{"nodes": [0, 1]}],
        "scene": 0,
    }
    return doc, blob


def test_gltf_ascii_roundtrip(tmp_path):
    doc, _ = _gltf_doc()
    p = tmp_path / "test.gltf"
    p.write_text(json.dumps(doc))
    scene = load_gltf(str(p))

    # de-indexed soup: 2 tris -> 6 verts, sequential indices
    assert scene.vertices.shape == (6, 3)
    np.testing.assert_array_equal(scene.indices, np.arange(6))
    assert len(scene.material_ids) == 2

    m = scene.materials[0]
    np.testing.assert_allclose(m["base_color"], [0.5, 0.25, 0.125])
    assert m["roughness"] == 0.0 and m["metallic"] == 0.75
    np.testing.assert_allclose(m["emission"], 5.0)  # strength applied
    assert m["is_light"] and m["is_thinfilm"]
    assert m["ideal_specular"]  # roughness 0 + transmission > 0
    assert m["ior"] == pytest.approx(1.6)
    assert m["clearcoat"] == pytest.approx(0.4)
    assert m["sheen"] == pytest.approx(0.3)

    # camera node
    assert scene.camera_animation_id == 1
    assert scene.camera_fov_from_file == pytest.approx(0.9)

    # node 0 animation: base pose key 0 + 2 channel keys
    anim = scene.animations[0]
    assert anim.translation.keys == [0.0, 0.0, 1.0]
    m0 = anim.get_affine(0.5)
    np.testing.assert_allclose(m0[:, 3], [1.0, 0.0, 0.0], atol=1e-6)

    # device build: light harvest picked up both emissive tris
    dev = build_device_scene(scene)
    assert dev.num_lights == 2


def test_glb_roundtrip(tmp_path):
    doc, _ = _gltf_doc()
    # move the buffer into the GLB BIN chunk
    blob = base64.b64decode(doc["buffers"][0]["uri"].split(",", 1)[1])
    doc["buffers"][0] = {"byteLength": len(blob)}
    js = json.dumps(doc).encode()
    js += b" " * ((4 - len(js) % 4) % 4)
    binc = blob + b"\x00" * ((4 - len(blob) % 4) % 4)
    glb = (
        struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(js) + 8 + len(binc))
        + struct.pack("<II", len(js), 0x4E4F534A)
        + js
        + struct.pack("<II", len(binc), 0x004E4942)
        + binc
    )
    p = tmp_path / "test.glb"
    p.write_bytes(glb)
    scene = load_gltf(str(p))
    assert scene.vertices.shape == (6, 3)
    np.testing.assert_allclose(scene.vertices[1], [1, 0, 0])


def test_glb_embedded_texture_roundtrip(tmp_path):
    """Images stored as GLB bufferViews (the normal .glb packaging) load
    into the atlas — tinygltf handles these in the reference
    (gltfloader.h:1068-1125)."""
    import jax.numpy as jnp

    from henjou.post.png import write_png

    doc, _ = _gltf_doc()
    blob = base64.b64decode(doc["buffers"][0]["uri"].split(",", 1)[1])

    # a 2x2 PNG: solid (255, 0, 0)
    img = np.zeros((2, 2, 3), np.uint8)
    img[..., 0] = 255
    png_path = tmp_path / "tex.png"
    write_png(str(png_path), img)
    png_bytes = png_path.read_bytes()

    pad = (4 - len(blob) % 4) % 4
    png_off = len(blob) + pad
    full = blob + b"\x00" * pad + png_bytes
    doc["buffers"][0] = {"byteLength": len(full)}
    doc["bufferViews"].append(
        {"buffer": 0, "byteOffset": png_off, "byteLength": len(png_bytes)}
    )
    doc["images"] = [{"bufferView": len(doc["bufferViews"]) - 1, "mimeType": "image/png"}]
    doc["textures"] = [{"source": 0}]
    doc["materials"][0]["pbrMetallicRoughness"]["baseColorTexture"] = {"index": 0}
    # texcoords so the sampled texture is addressable
    tc = np.zeros((4, 2), np.float32)
    tc_off = len(full)
    full = full + tc.tobytes()
    doc["buffers"][0] = {"byteLength": len(full)}
    doc["bufferViews"].append(
        {"buffer": 0, "byteOffset": tc_off, "byteLength": tc.nbytes}
    )
    doc["accessors"].append(
        {"bufferView": len(doc["bufferViews"]) - 1, "componentType": 5126,
         "count": 4, "type": "VEC2"}
    )
    doc["meshes"][0]["primitives"][0]["attributes"]["TEXCOORD_0"] = (
        len(doc["accessors"]) - 1
    )

    js = json.dumps(doc).encode()
    js += b" " * ((4 - len(js) % 4) % 4)
    binc = full + b"\x00" * ((4 - len(full) % 4) % 4)
    glb = (
        struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(js) + 8 + len(binc))
        + struct.pack("<II", len(js), 0x4E4F534A)
        + js
        + struct.pack("<II", len(binc), 0x004E4942)
        + binc
    )
    p = tmp_path / "tex.glb"
    p.write_bytes(glb)
    scene = load_gltf(str(p))
    assert len(scene.textures) == 1, "bufferView image was dropped"
    assert scene.materials[0]["base_color_tex"] == 0
    # sRGB-decoded solid red
    np.testing.assert_allclose(scene.textures[0].data[0, 0, :3], [1, 0, 0], atol=1e-3)
    dev = build_device_scene(scene)
    assert dev.has_base_tex


def test_sparse_accessor_substitution(tmp_path):
    """Sparse accessors (glTF 2.0 §3.6.2.3): base values overridden at the
    sparse indices."""
    doc, _ = _gltf_doc()
    blob = base64.b64decode(doc["buffers"][0]["uri"].split(",", 1)[1])

    sidx = np.asarray([2], np.uint16)
    sval = np.asarray([[5.0, 5.0, 5.0]], np.float32)
    off_i = len(blob)
    off_v = off_i + sidx.nbytes + 2  # pad to 4
    full = blob + sidx.tobytes() + b"\x00\x00" + sval.tobytes()
    doc["buffers"][0]["byteLength"] = len(full)
    doc["buffers"][0]["uri"] = (
        "data:application/octet-stream;base64," + base64.b64encode(full).decode()
    )
    doc["bufferViews"].append({"buffer": 0, "byteOffset": off_i, "byteLength": sidx.nbytes})
    doc["bufferViews"].append({"buffer": 0, "byteOffset": off_v, "byteLength": sval.nbytes})
    # position accessor (index 0) becomes sparse: vertex 2 moves to (5,5,5)
    doc["accessors"][0]["sparse"] = {
        "count": 1,
        "indices": {"bufferView": len(doc["bufferViews"]) - 2, "componentType": 5123},
        "values": {"bufferView": len(doc["bufferViews"]) - 1},
    }
    p = tmp_path / "sparse.gltf"
    p.write_text(json.dumps(doc))
    scene = load_gltf(str(p))
    # de-indexed tri 0 = verts (0,1,2): corner 2 carries the sparse value
    np.testing.assert_allclose(scene.vertices[2], [5, 5, 5])


OBJ_TEXT = """
mtllib test.mtl
o quad
usemtl red
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
f 1 2 3 4
o tri
usemtl glow
v 0 0 5
v 1 0 5
v 0 1 5
f -3 -2 -1
"""

MTL_TEXT = """
newmtl red
Kd 0.8 0.1 0.1
Ni 1.45
Pr 0.7
Pm 0.2
Ps 0.1
Pc 0.5
Pcr 0.3
newmtl glow
Kd 1 1 1
Ke 4 4 4
"""


def test_obj_loader(tmp_path):
    (tmp_path / "test.obj").write_text(OBJ_TEXT)
    (tmp_path / "test.mtl").write_text(MTL_TEXT)
    scene = load_obj(str(tmp_path / "test.obj"))

    # quad fan-triangulated -> 2 tris, plus 1 tri shape = 3 tris, 9 verts
    assert len(scene.material_ids) == 3
    assert scene.vertices.shape == (9, 3)
    assert len(scene.geometries) == 2 and len(scene.instances) == 2
    assert scene.geometries[0].index_count == 6
    assert scene.geometries[1].index_offset == 6

    red = scene.materials[0]
    np.testing.assert_allclose(red["base_color"], [0.8, 0.1, 0.1])
    assert red["roughness"] == pytest.approx(0.7)
    assert red["metallic"] == pytest.approx(0.2)
    assert red["sheen"] == pytest.approx(0.1)
    assert red["clearcoat"] == pytest.approx(0.5)  # Pc
    assert red["subsurface"] == pytest.approx(0.3)  # Pcr -> subsurface
    assert red["ior"] == pytest.approx(1.45)
    glow = scene.materials[1]
    assert glow["is_light"]

    # negative indices resolved; face normals generated (+z for both shapes)
    np.testing.assert_allclose(scene.normals[:, 2], 1.0, atol=1e-6)

    dev = build_device_scene(scene)
    assert dev.num_lights == 1  # one emissive triangle


def test_obj_without_mtl(tmp_path):
    (tmp_path / "plain.obj").write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    scene = load_obj(str(tmp_path / "plain.obj"))
    assert len(scene.materials) == 1
    np.testing.assert_allclose(scene.materials[0]["base_color"], 1.0)


def test_gltf_vertex_colors(tmp_path):
    """COLOR_0 must reach SceneData.colors (ref scene.h:25, uploaded at
    renderer.h:1198): float vec3 case + normalized-ubyte vec4 case."""
    import json

    positions = np.asarray(
        [[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32
    )
    col_f = np.asarray([[1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    col_u8 = np.asarray(
        [[255, 0, 0, 255], [0, 127, 0, 255], [0, 0, 255, 255]], np.uint8
    )
    blob = positions.tobytes() + col_f.tobytes() + col_u8.tobytes()
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [
            {
                "byteLength": len(blob),
                "uri": "data:application/octet-stream;base64,"
                + base64.b64encode(blob).decode(),
            }
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": positions.nbytes},
            {
                "buffer": 0,
                "byteOffset": positions.nbytes,
                "byteLength": col_f.nbytes,
            },
            {
                "buffer": 0,
                "byteOffset": positions.nbytes + col_f.nbytes,
                "byteLength": col_u8.nbytes,
            },
        ],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 3, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 3, "type": "VEC3"},
            {
                "bufferView": 2,
                "componentType": 5121,
                "count": 3,
                "type": "VEC4",
                "normalized": True,
            },
        ],
        "meshes": [
            {
                "primitives": [
                    {"attributes": {"POSITION": 0, "COLOR_0": 1}},
                    {"attributes": {"POSITION": 0, "COLOR_0": 2}},
                ]
            }
        ],
        "nodes": [{"mesh": 0}],
        "scenes": [{"nodes": [0]}],
        "scene": 0,
    }
    p = tmp_path / "vc.gltf"
    p.write_text(json.dumps(doc))
    from henjou.scene.gltf import load_gltf

    scene = load_gltf(str(p))
    assert scene.colors is not None
    cols = np.asarray(scene.colors).reshape(-1, 3)
    assert cols.shape[0] == 6  # two de-indexed triangles
    np.testing.assert_allclose(cols[:3], col_f, atol=1e-6)
    np.testing.assert_allclose(
        cols[3:], col_u8[:, :3].astype(np.float32) / 255.0, atol=1e-6
    )
    # and the device scene must see them (has_vert_colors static flag)
    from henjou.scene.scenedata import build_device_scene

    dev = build_device_scene(scene)
    assert dev.has_vert_colors


def test_obj_vertex_colors(tmp_path):
    """`v x y z r g b` vertex-color extension (tinyobj attrib.colors)."""
    p = tmp_path / "vc.obj"
    p.write_text(
        "v 0 0 0 1 0 0\n"
        "v 1 0 0 0 1 0\n"
        "v 0 1 0 0 0 1\n"
        "f 1 2 3\n"
    )
    from henjou.scene.obj import load_obj

    scene = load_obj(str(p))
    assert scene.colors is not None
    np.testing.assert_allclose(
        np.asarray(scene.colors),
        [[1, 0, 0], [0, 1, 0], [0, 0, 1]],
        atol=1e-6,
    )
