"""glTF 2.0 loader: hand-rolled .gltf/.glb parser -> SceneData.

Behavior-parity rebuild of the reference's tinygltf-based loader
(include/loader/gltfloader.h:1068-1601), with the same semantics:

- every mesh primitive is flattened into the global DE-INDEXED triangle
  soup with sequential indices (gltfloader.h:1484-1492); face normals are
  generated when missing (gltfloader.h:1465-1470); texcoords default 0.
- PBR metallic-roughness materials; metallic_tex aliases the
  roughness texture (gltfloader.h:1157); emissive factor scaled by
  KHR_materials_emissive_strength; is_light when emissive sum > 0
  (gltfloader.h:1162-1168); KHR extensions clearcoat / sheen /
  transmission / ior; the custom `ThinFilm` extension sets is_thinfilm
  (gltfloader.h:1194-1258); ideal_specular = (roughness == 0 and
  transmission > 0) (gltfloader.h:1260-1263).
- per-node TRS base pose seeds a 1-key animation; animation channels
  append keyed data to the target node's tracks (gltfloader.h:1312-1343,
  1536-1589). Animations are indexed BY NODE id.
- a camera node (when allow_camera_animation) resets camera pos/dir to
  the origin looking -z, records its node id as camera_animation_id, and
  overrides the fov with the camera's yfov (gltfloader.h:1514-1522).
- emissive triangles harvested into the light lists (gltfloader.h:1496-1500).

No tinygltf: pure python/numpy (JSON + GLB container + data URIs),
strided accessor reads via numpy as_strided.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import struct
from typing import Optional

import numpy as np

from henjou.scene.animation import Animation, AnimationTrack, static_animation
from henjou.scene.scenedata import (
    GeometryData,
    InstanceData,
    SceneData,
    make_material,
)
from henjou.texture.texture import Texture, TexType, load_texture_cached

log = logging.getLogger("henjou")

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_NCOMP = {
    "SCALAR": 1,
    "VEC2": 2,
    "VEC3": 3,
    "VEC4": 4,
    "MAT2": 4,
    "MAT3": 9,
    "MAT4": 16,
}


def _load_glb(path: str):
    with open(path, "rb") as f:
        data = f.read()
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:  # 'glTF'
        raise ValueError(f"not a GLB file: {path}")
    offset = 12
    gltf_json = None
    bin_chunk = None
    while offset < len(data):
        chunk_len, chunk_type = struct.unpack_from("<II", data, offset)
        chunk = data[offset + 8 : offset + 8 + chunk_len]
        if chunk_type == 0x4E4F534A:  # JSON
            gltf_json = json.loads(chunk.decode("utf-8"))
        elif chunk_type == 0x004E4942:  # BIN
            bin_chunk = chunk
        offset += 8 + chunk_len
    if gltf_json is None:
        raise ValueError(f"GLB without JSON chunk: {path}")
    return gltf_json, bin_chunk


class _Gltf:
    """Parsed glTF document with accessor reads."""

    def __init__(self, path: str):
        self.dir = os.path.dirname(os.path.abspath(path))
        self.bin_chunk: Optional[bytes] = None
        if path.lower().endswith(".glb"):
            self.doc, self.bin_chunk = _load_glb(path)
        else:
            with open(path) as f:
                self.doc = json.load(f)
        self._buffers = {}

    def buffer(self, idx: int) -> bytes:
        if idx in self._buffers:
            return self._buffers[idx]
        spec = self.doc["buffers"][idx]
        uri = spec.get("uri")
        if uri is None:
            data = self.bin_chunk
        elif uri.startswith("data:"):
            data = base64.b64decode(uri.split(",", 1)[1])
        else:
            from urllib.parse import unquote

            with open(os.path.join(self.dir, unquote(uri)), "rb") as f:
                data = f.read()
        self._buffers[idx] = data
        return data

    def buffer_view_bytes(self, bv_idx: int) -> bytes:
        """Raw bytes of a bufferView (embedded GLB images live here)."""
        bv = self.doc["bufferViews"][bv_idx]
        buf = self.buffer(bv["buffer"])
        off = bv.get("byteOffset", 0)
        return buf[off : off + bv["byteLength"]]

    def _read_packed(self, bv_idx: int, byte_offset: int, dtype, ncomp, count):
        bv = self.doc["bufferViews"][bv_idx]
        buf = self.buffer(bv["buffer"])
        offset = bv.get("byteOffset", 0) + byte_offset
        elem_size = dtype.itemsize * ncomp
        stride = bv.get("byteStride", 0) or elem_size
        raw = np.frombuffer(
            buf, np.uint8, count=stride * (count - 1) + elem_size, offset=offset
        )
        strided = np.lib.stride_tricks.as_strided(
            raw, shape=(count, elem_size), strides=(stride, 1)
        )
        return np.ascontiguousarray(strided).view(dtype).reshape(count, ncomp)

    def accessor(self, idx: int) -> np.ndarray:
        """Read accessor idx as [count, ncomp] (or [count] for scalars),
        including sparse substitution (glTF 2.0 §3.6.2.3: base values —
        zeros when no bufferView — overridden at sparse indices)."""
        acc = self.doc["accessors"][idx]
        dtype = np.dtype(_COMPONENT_DTYPES[acc["componentType"]])
        ncomp = _TYPE_NCOMP[acc["type"]]
        count = acc["count"]
        if "bufferView" in acc:
            out = self._read_packed(
                acc["bufferView"], acc.get("byteOffset", 0), dtype, ncomp, count
            ).copy()
        else:
            out = np.zeros((count, ncomp), dtype)
        sparse = acc.get("sparse")
        if sparse:
            n = sparse["count"]
            sidx = sparse["indices"]
            idx_dtype = np.dtype(_COMPONENT_DTYPES[sidx["componentType"]])
            indices = self._read_packed(
                sidx["bufferView"], sidx.get("byteOffset", 0), idx_dtype, 1, n
            ).reshape(-1)
            sval = sparse["values"]
            values = self._read_packed(
                sval["bufferView"], sval.get("byteOffset", 0), dtype, ncomp, n
            )
            out[indices.astype(np.int64)] = values
        return out[:, 0] if ncomp == 1 else out


def _ext_scalar(extensions: dict, ext_name: str, key: str, default):
    ext = extensions.get(ext_name)
    if isinstance(ext, dict) and key in ext:
        return ext[key]
    return default


def _harvest_material(g: "_Gltf", mat: dict, textures, tex_cache):
    """One glTF material -> uber material (gltfloader.h:1125-1267).

    Images resolve from file URIs, data URIs, AND GLB bufferViews — the
    reference's tinygltf handles all three (gltfloader.h:1068-1125)."""
    doc = g.doc

    def load_tex(tex_index, tex_type) -> int:
        img = doc["images"][doc["textures"][tex_index]["source"]]
        uri = img.get("uri")
        if uri and not uri.startswith("data:"):
            return load_texture_cached(textures, tex_cache, uri, g.dir, tex_type)
        # in-memory image: data URI or GLB bufferView
        if uri:
            key = ("datauri", hash(uri), tex_type)
            raw = base64.b64decode(uri.split(",", 1)[1])
        elif "bufferView" in img:
            key = ("bufferview", img["bufferView"], tex_type)
            raw = None
        else:
            return -1
        if key in tex_cache:
            return tex_cache[key]
        if raw is None:
            raw = g.buffer_view_bytes(img["bufferView"])
        from henjou.texture.texture import load_texture_bytes

        try:
            tex = load_texture_bytes(
                raw, img.get("name", str(key)), tex_type, img.get("mimeType", "")
            )
        except ValueError as e:
            log.warning("embedded texture load failed: %s", e)
            tex_cache[key] = -1
            return -1
        textures.append(tex)
        tex_cache[key] = len(textures) - 1
        return tex_cache[key]

    pbr = mat.get("pbrMetallicRoughness", {})
    base_factor = pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])

    base_tex = -1
    if "baseColorTexture" in pbr:
        base_tex = load_tex(pbr["baseColorTexture"]["index"], TexType.SRGB)

    roughness = float(pbr.get("roughnessFactor", 1.0))
    rough_tex = -1
    if "metallicRoughnessTexture" in pbr:
        rough_tex = load_tex(
            pbr["metallicRoughnessTexture"]["index"], TexType.NON_COLOR
        )

    normal_tex = -1
    if "normalTexture" in mat:
        normal_tex = load_tex(mat["normalTexture"]["index"], TexType.NON_COLOR)

    # beyond-reference: the reference only Dump()s emissiveTexture
    # (gltfloader.h:712) and never fills a material slot; our hit path
    # applies it (payload.py), so harvest it here.
    emission_tex = -1
    if "emissiveTexture" in mat:
        emission_tex = load_tex(mat["emissiveTexture"]["index"], TexType.SRGB)

    emission = np.asarray(mat.get("emissiveFactor", [0.0, 0.0, 0.0]), np.float32)
    ext = mat.get("extensions", {})
    emission = emission * float(
        _ext_scalar(ext, "KHR_materials_emissive_strength", "emissiveStrength", 1.0)
    )

    clearcoat = float(_ext_scalar(ext, "KHR_materials_clearcoat", "clearcoatFactor", 0.0))
    sheen = float(_ext_scalar(ext, "KHR_materials_sheen", "sheenRoughnessFactor", 0.0))
    transmission = float(
        _ext_scalar(ext, "KHR_materials_transmission", "transmissionFactor", 0.0)
    )
    ior = float(_ext_scalar(ext, "KHR_materials_ior", "ior", 1.0))
    is_thinfilm = "is_ThinFilm" in (ext.get("ThinFilm") or {})

    is_light = bool(emission.sum() > 0.0)
    ideal_specular = roughness == 0.0 and transmission > 0.0

    return make_material(
        name=mat.get("name", ""),
        base_color=base_factor[:3],
        base_color_tex=base_tex,
        roughness=roughness,
        roughness_tex=rough_tex,
        metallic=float(pbr.get("metallicFactor", 1.0)),
        metallic_tex=rough_tex,  # gltfloader.h:1157
        sheen=sheen,
        clearcoat=clearcoat,
        subsurface=0.0,
        ior=ior,
        transmission=transmission,
        normal_tex=normal_tex,
        emission=emission,
        emission_tex=emission_tex,
        is_light=is_light,
        ideal_specular=ideal_specular,
        is_thinfilm=is_thinfilm,
    )


def load_gltf(path: str, allow_camera_animation: bool = True) -> SceneData:
    g = _Gltf(path)
    doc = g.doc

    textures: list = []
    tex_cache: dict = {}
    materials = [
        _harvest_material(g, m, textures, tex_cache)
        for m in doc.get("materials", [])
    ]
    if not materials:
        materials = [make_material("default")]

    nodes = doc.get("nodes", [])
    animations = [
        static_animation(
            n.get("translation", (0, 0, 0)),
            n.get("rotation", (0, 0, 0, 1)),
            n.get("scale", (1, 1, 1)),
        )
        for n in nodes
    ]

    vertices, normals, texcoords, indices = [], [], [], []
    colors: list = []
    any_colors = False
    material_ids = []
    geometries, instances = [], []
    camera_animation_id = -1
    camera_fov = None

    for node_index, node in enumerate(nodes):
        mesh_id = node.get("mesh", -1)
        cam_id = node.get("camera", -1)
        if mesh_id != -1:
            mesh = doc["meshes"][mesh_id]
            tri_count_before = sum(len(m) for m in material_ids)
            index_offset = tri_count_before * 3
            for prim in mesh.get("primitives", []):
                attrs = prim.get("attributes", {})
                pos = g.accessor(attrs["POSITION"]).astype(np.float32)
                nrm = (
                    g.accessor(attrs["NORMAL"]).astype(np.float32)
                    if "NORMAL" in attrs
                    else None
                )
                tc = (
                    g.accessor(attrs["TEXCOORD_0"]).astype(np.float32)
                    if "TEXCOORD_0" in attrs
                    else None
                )
                # COLOR_0: vec3/vec4 float or normalized ubyte/ushort
                # (glTF 2.0 §3.7.2.1); alpha dropped — the device model
                # carries RGB only (ref scene.h:25, renderer.h:1198)
                col = None
                if "COLOR_0" in attrs:
                    raw = g.accessor(attrs["COLOR_0"])
                    scale = {np.uint8: 255.0, np.uint16: 65535.0}.get(
                        raw.dtype.type, 1.0
                    )
                    col = raw[:, :3].astype(np.float32) / scale
                    any_colors = True
                if "indices" in prim:
                    idx = g.accessor(prim["indices"]).astype(np.uint32).reshape(-1)
                else:
                    idx = np.arange(len(pos), dtype=np.uint32)
                idx = idx.reshape(-1, 3)

                v = pos[idx.reshape(-1)].reshape(-1, 3, 3)
                if nrm is not None:
                    n3 = nrm[idx.reshape(-1)].reshape(-1, 3, 3)
                else:
                    face_n = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
                    face_n /= np.maximum(
                        np.linalg.norm(face_n, axis=-1, keepdims=True), 1e-20
                    )
                    n3 = np.repeat(face_n[:, None, :], 3, axis=1)
                if tc is not None:
                    t3 = tc[idx.reshape(-1)].reshape(-1, 3, 2)
                else:
                    t3 = np.zeros((len(idx), 3, 2), np.float32)

                if col is not None:
                    c3 = col[idx.reshape(-1)].reshape(-1, 3, 3)
                else:
                    c3 = np.ones((len(idx), 3, 3), np.float32)

                vertices.append(v.reshape(-1, 3))
                normals.append(n3.reshape(-1, 3))
                texcoords.append(t3.reshape(-1, 2))
                colors.append(c3.reshape(-1, 3))
                mat_id = prim.get("material", 0)
                material_ids.append(np.full(len(idx), mat_id, np.uint32))

            index_count = sum(len(m) for m in material_ids) * 3 - index_offset
            geometries.append(GeometryData(index_offset, index_count))
            instances.append(
                InstanceData(geometry_id=len(geometries) - 1, animation_id=node_index)
            )
        elif cam_id != -1 and allow_camera_animation:
            camera_animation_id = node_index
            camera_fov = float(
                doc["cameras"][cam_id].get("perspective", {}).get("yfov", 0.7854)
            )

    if not vertices:
        raise ValueError(f"glTF has no mesh geometry: {path}")

    all_verts = np.concatenate(vertices)
    all_normals = np.concatenate(normals)
    all_texcoords = np.concatenate(texcoords)
    all_mat_ids = np.concatenate(material_ids)
    all_indices = np.arange(len(all_verts), dtype=np.uint32)

    # ---- animation channels append onto the node base poses ----
    for anim in doc.get("animations", []):
        samplers = anim.get("samplers", [])
        for channel in anim.get("channels", []):
            sampler = samplers[channel["sampler"]]
            target = channel.get("target", {})
            node_id = target.get("node", -1)
            path_name = target.get("path")
            if node_id < 0 or path_name not in ("translation", "rotation", "scale"):
                continue
            keys = g.accessor(sampler["input"]).astype(np.float32).reshape(-1)
            data = g.accessor(sampler["output"]).astype(np.float32)
            track: AnimationTrack = getattr(
                animations[node_id],
                {"translation": "translation", "rotation": "rotation", "scale": "scale"}[
                    path_name
                ],
            )
            for k, val in zip(keys, data):
                track.keys.append(float(k))
                track.values.append(val.tolist())
            track.interpolation = sampler.get("interpolation", "LINEAR")

    scene = SceneData(
        vertices=all_verts,
        indices=all_indices,
        material_ids=all_mat_ids,
        normals=all_normals,
        texcoords=all_texcoords,
        colors=(np.concatenate(colors) if any_colors and colors else None),
        materials=materials,
        textures=textures,
        animations=animations,
        geometries=geometries,
        instances=instances,
        camera_animation_id=camera_animation_id,
        camera_fov_from_file=camera_fov,
    )
    log.info(
        "glTF loaded: %d tris, %d materials, %d instances, %d textures, %d nodes",
        len(all_mat_ids),
        len(materials),
        len(instances),
        len(textures),
        len(nodes),
    )
    return scene
