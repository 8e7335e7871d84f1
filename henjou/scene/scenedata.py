"""Scene model: host SoA -> device pytrees.

Rebuild of the reference's SceneData/GeometryData/InstanceData
(include/renderer/scene.h:9-36) and Material (include/renderer/material.h:10-63),
re-shaped for XLA:

- Host side (`SceneData`): numpy SoA filled by the loaders, one de-indexed
  global triangle soup shared by all geometries (mirroring
  gltfloader.h:1484-1492 semantics).
- Device side (`DeviceScene`): jnp arrays, a pytree that jitted stages close
  over. Instead of OptiX GAS/IAS handles, we carry per-triangle index maps
  (tri -> vertex ids / instance / material) so the whole scene flattens to
  world space with one batched gather+transform per frame (`FrameScene`) —
  the replacement for the reference's per-frame IAS rebuild
  (renderer.h:257-291,1133).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from henjou.math.affine import identity_affine
from henjou.math.vec import transform_normal, transform_position


# ---------------------------------------------------------------------------
# Host-side model (numpy)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GeometryData:
    """Index range of one geometry in the global index buffer
    (reference: scene.h:9-12)."""

    index_offset: int
    index_count: int


@dataclasses.dataclass
class InstanceData:
    """One placed geometry (reference: scene.h:14-17)."""

    geometry_id: int
    animation_id: int = -1


def make_material(
    name: str = "default",
    base_color=(0.8, 0.8, 0.8),
    base_color_tex: int = -1,
    specular=(0.0, 0.0, 0.0),
    specular_tex: int = -1,
    roughness: float = 0.5,
    roughness_tex: int = -1,
    metallic: float = 0.0,
    metallic_tex: int = -1,
    sheen: float = 0.0,
    sheen_tex: int = -1,
    subsurface: float = 0.0,
    subsurface_tex: int = -1,
    clearcoat: float = 0.0,
    clearcoat_tex: int = -1,
    ior: float = 1.45,
    transmission: float = 0.0,
    normal_tex: int = -1,
    bump_tex: int = -1,
    emission=(0.0, 0.0, 0.0),
    emission_tex: int = -1,
    is_light: bool = False,
    ideal_specular: bool = False,
    is_thinfilm: bool = False,
) -> dict:
    """14-slot uber material (reference: include/renderer/material.h:10-63)."""
    return dict(
        name=name,
        base_color=np.asarray(base_color, np.float32),
        base_color_tex=base_color_tex,
        specular=np.asarray(specular, np.float32),
        specular_tex=specular_tex,
        roughness=float(roughness),
        roughness_tex=roughness_tex,
        metallic=float(metallic),
        metallic_tex=metallic_tex,
        sheen=float(sheen),
        sheen_tex=sheen_tex,
        subsurface=float(subsurface),
        subsurface_tex=subsurface_tex,
        clearcoat=float(clearcoat),
        clearcoat_tex=clearcoat_tex,
        ior=float(ior),
        transmission=float(transmission),
        normal_tex=normal_tex,
        bump_tex=bump_tex,
        emission=np.asarray(emission, np.float32),
        emission_tex=emission_tex,
        is_light=bool(is_light),
        ideal_specular=bool(ideal_specular),
        is_thinfilm=bool(is_thinfilm),
    )


@dataclasses.dataclass
class SceneData:
    """Host scene SoA (reference: scene.h:19-36)."""

    vertices: np.ndarray  # [V,3] f32 object space
    indices: np.ndarray  # [3T] u32 into vertices
    material_ids: np.ndarray  # [T] u32 per triangle of the GLOBAL soup
    normals: np.ndarray  # [V,3] f32
    texcoords: np.ndarray  # [V,2] f32
    colors: np.ndarray  # [V,3] f32 vertex colors

    materials: list  # list of make_material() dicts
    textures: list = dataclasses.field(default_factory=list)  # Texture objects
    animations: list = dataclasses.field(default_factory=list)
    geometries: list = dataclasses.field(default_factory=list)  # GeometryData
    instances: list = dataclasses.field(default_factory=list)  # InstanceData
    camera_animation_id: int = -1
    camera_fov_from_file: Optional[float] = None

    def __post_init__(self):
        self.vertices = np.asarray(self.vertices, np.float32).reshape(-1, 3)
        self.indices = np.asarray(self.indices, np.uint32).reshape(-1)
        self.material_ids = np.asarray(self.material_ids, np.uint32).reshape(-1)
        v = len(self.vertices)
        if self.normals is None or len(self.normals) == 0:
            self.normals = np.zeros((v, 3), np.float32)
        if self.texcoords is None or len(self.texcoords) == 0:
            self.texcoords = np.zeros((v, 2), np.float32)
        if self.colors is None or len(self.colors) == 0:
            self.colors = np.ones((v, 3), np.float32)
        self.normals = np.asarray(self.normals, np.float32).reshape(-1, 3)
        self.texcoords = np.asarray(self.texcoords, np.float32).reshape(-1, 2)
        self.colors = np.asarray(self.colors, np.float32).reshape(-1, 3)
        if not self.geometries:
            self.geometries = [GeometryData(0, len(self.indices))]
        if not self.instances:
            self.instances = [InstanceData(0)]


# ---------------------------------------------------------------------------
# Device-side pytrees (jnp)
# ---------------------------------------------------------------------------


class MaterialTable(NamedTuple):
    """Material SoA indexed by material id — replaces the reference's
    2-per-material SBT hitgroup records (renderer.h:620-739): a gather by
    material id is the XLA analogue of an SBT record fetch."""

    base_color: jnp.ndarray  # [M,3]
    base_color_tex: jnp.ndarray  # [M] i32, -1 = none
    roughness: jnp.ndarray  # [M]
    roughness_tex: jnp.ndarray
    metallic: jnp.ndarray
    metallic_tex: jnp.ndarray
    sheen: jnp.ndarray
    subsurface: jnp.ndarray
    clearcoat: jnp.ndarray
    ior: jnp.ndarray
    transmission: jnp.ndarray
    normal_tex: jnp.ndarray
    bump_tex: jnp.ndarray
    emission: jnp.ndarray  # [M,3]
    emission_tex: jnp.ndarray
    is_light: jnp.ndarray  # [M] bool
    ideal_specular: jnp.ndarray  # [M] bool
    is_thinfilm: jnp.ndarray  # [M] bool


# Packed-row layouts: the payload fill gathers ONE wide row per table
# instead of one narrow row per field (~40 gathers/hit -> 3). Column indices below are the single source of truth.

# tri_attr [T, 24]: per-instanced-triangle interpolation attributes
TRI_TC0, TRI_TC1, TRI_TC2 = 0, 2, 4  # texcoords, 2 each
TRI_COL0, TRI_COL1, TRI_COL2 = 6, 9, 12  # vertex colors, 3 each
TRI_MAT = 15  # material id (exact float-encoded int)
TRI_INST = 16  # instance id
TRI_ROW_W = 24

# mat_rows [M, 48]: the SBT-record analogue, one row per material
MAT_BASE = 0  # base_color rgb
MAT_EMISSION = 3  # emission rgb
MAT_ROUGH = 6
MAT_METAL = 7
MAT_SUBSURF = 8
MAT_SHEEN = 9
MAT_CLEARCOAT = 10
MAT_IOR = 11
MAT_TRANSMISSION = 12
MAT_SPECFLAG = 13  # ideal_specular
MAT_LIGHTFLAG = 14  # is_light
MAT_FILMFLAG = 15  # is_thinfilm
# texture atlas rects (oy, ox, h, w); h == 0 means "no texture"
MAT_BASE_RECT = 16
MAT_ROUGH_RECT = 20
MAT_METAL_RECT = 24
MAT_NORMAL_RECT = 28
MAT_BUMP_RECT = 32
MAT_EMISSION_RECT = 36
MAT_ROW_W = 48


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DeviceScene:
    """Static device buffers (uploaded once, cpySceneDataToDevice analogue,
    renderer.h:197-255). `num_lights` and the has_* texture-usage facts are
    static metadata so light-count logic and texture sampling code are
    compile-time gated (lockstep lanes pay for every compiled gather)."""

    vertices: jnp.ndarray  # [V,3] object space
    normals: jnp.ndarray  # [V,3]
    texcoords: jnp.ndarray  # [V,2]
    colors: jnp.ndarray  # [V,3]
    tri_vidx: jnp.ndarray  # [T,3] u32 global vertex ids per instanced tri
    tri_instance: jnp.ndarray  # [T] u32 owning instance
    tri_material: jnp.ndarray  # [T] u32
    tri_attr: jnp.ndarray  # [T,TRI_ROW_W] packed interpolation row
    mat_rows: jnp.ndarray  # [M,MAT_ROW_W] packed material row (SBT record)
    prim_offsets: jnp.ndarray  # [I] u32 first global tri of each instance
    materials: MaterialTable
    light_prim_ids: jnp.ndarray  # [L] u32 global tri ids (emissive)
    light_prim_emission: jnp.ndarray  # [L,3]
    atlas: "TextureAtlas"  # packed scene textures (textureBind analogue)
    num_lights: int = dataclasses.field(metadata=dict(static=True))
    has_base_tex: bool = dataclasses.field(default=False, metadata=dict(static=True))
    has_mr_tex: bool = dataclasses.field(default=False, metadata=dict(static=True))
    has_normal_tex: bool = dataclasses.field(default=False, metadata=dict(static=True))
    has_bump_tex: bool = dataclasses.field(default=False, metadata=dict(static=True))
    has_emission_tex: bool = dataclasses.field(default=False, metadata=dict(static=True))
    has_vert_colors: bool = dataclasses.field(default=False, metadata=dict(static=True))


class FrameScene(NamedTuple):
    """Per-frame world-space build (the IAS-rebuild analogue): everything a
    trace needs, already in world space."""

    tri_verts: jnp.ndarray  # [T,3,3] world-space triangle vertices
    tri_normals: jnp.ndarray  # [T,3,3] world-space per-vertex shading normals
    device: DeviceScene
    transforms: jnp.ndarray  # [I,3,4]
    inv_transforms: jnp.ndarray  # [I,3,4]


def build_device_scene(scene: SceneData) -> DeviceScene:
    """Upload host SoA and precompute the per-instanced-triangle index maps.

    Instances referencing the same geometry each get their own global
    triangle range (prim_offsets, matching the reference's per-instance
    prim_offset buffer consumed by light_sample.h:26-42)."""
    tri_vidx_list = []
    tri_inst_list = []
    tri_mat_list = []
    prim_offsets = []
    offset = 0
    for inst_id, inst in enumerate(scene.instances):
        geom = scene.geometries[inst.geometry_id]
        i0 = geom.index_offset
        cnt = geom.index_count
        idx = scene.indices[i0 : i0 + cnt].reshape(-1, 3)
        ntri = len(idx)
        tri_vidx_list.append(idx)
        tri_inst_list.append(np.full(ntri, inst_id, np.uint32))
        tri_mat_list.append(scene.material_ids[i0 // 3 : i0 // 3 + ntri])
        prim_offsets.append(offset)
        offset += ntri

    tri_vidx = np.concatenate(tri_vidx_list, axis=0).astype(np.uint32)
    tri_instance = np.concatenate(tri_inst_list)
    tri_material = np.concatenate(tri_mat_list).astype(np.uint32)

    # Harvest emissive triangles into the light list (gltfloader.h:1496-1500
    # semantics: any triangle whose material has is_light set).
    light_ids = []
    light_emission = []
    for t in range(len(tri_material)):
        m = scene.materials[int(tri_material[t])]
        if m["is_light"]:
            light_ids.append(t)
            light_emission.append(m["emission"])
    if light_ids:
        light_prim_ids = np.asarray(light_ids, np.uint32)
        light_prim_emission = np.asarray(light_emission, np.float32)
    else:
        light_prim_ids = np.zeros((1,), np.uint32)
        light_prim_emission = np.zeros((1, 3), np.float32)

    mats = scene.materials
    table = MaterialTable(
        base_color=jnp.asarray(np.stack([m["base_color"] for m in mats])),
        base_color_tex=jnp.asarray([m["base_color_tex"] for m in mats], jnp.int32),
        roughness=jnp.asarray([m["roughness"] for m in mats], jnp.float32),
        roughness_tex=jnp.asarray([m["roughness_tex"] for m in mats], jnp.int32),
        metallic=jnp.asarray([m["metallic"] for m in mats], jnp.float32),
        metallic_tex=jnp.asarray([m["metallic_tex"] for m in mats], jnp.int32),
        sheen=jnp.asarray([m["sheen"] for m in mats], jnp.float32),
        subsurface=jnp.asarray([m["subsurface"] for m in mats], jnp.float32),
        clearcoat=jnp.asarray([m["clearcoat"] for m in mats], jnp.float32),
        ior=jnp.asarray([m["ior"] for m in mats], jnp.float32),
        transmission=jnp.asarray([m["transmission"] for m in mats], jnp.float32),
        normal_tex=jnp.asarray([m["normal_tex"] for m in mats], jnp.int32),
        bump_tex=jnp.asarray([m["bump_tex"] for m in mats], jnp.int32),
        emission=jnp.asarray(np.stack([m["emission"] for m in mats])),
        emission_tex=jnp.asarray([m["emission_tex"] for m in mats], jnp.int32),
        is_light=jnp.asarray([m["is_light"] for m in mats], jnp.bool_),
        ideal_specular=jnp.asarray([m["ideal_specular"] for m in mats], jnp.bool_),
        is_thinfilm=jnp.asarray([m["is_thinfilm"] for m in mats], jnp.bool_),
    )

    from henjou.texture.atlas import build_atlas

    atlas = build_atlas(scene.textures)

    # ---- packed per-triangle interpolation rows (one gather per hit) ----
    t_count = len(tri_material)
    tri_attr = np.zeros((t_count, TRI_ROW_W), np.float32)
    tc = scene.texcoords[tri_vidx]  # [T,3,2]
    col = scene.colors[tri_vidx]  # [T,3,3]
    tri_attr[:, TRI_TC0 : TRI_TC0 + 2] = tc[:, 0]
    tri_attr[:, TRI_TC1 : TRI_TC1 + 2] = tc[:, 1]
    tri_attr[:, TRI_TC2 : TRI_TC2 + 2] = tc[:, 2]
    tri_attr[:, TRI_COL0 : TRI_COL0 + 3] = col[:, 0]
    tri_attr[:, TRI_COL1 : TRI_COL1 + 3] = col[:, 1]
    tri_attr[:, TRI_COL2 : TRI_COL2 + 3] = col[:, 2]
    tri_attr[:, TRI_MAT] = tri_material.astype(np.float32)
    tri_attr[:, TRI_INST] = tri_instance.astype(np.float32)

    # ---- packed material rows incl. texture atlas rects (SBT analogue) ----
    off_np = np.asarray(atlas.offset)
    size_np = np.asarray(atlas.size)

    def _rect(tex_id: int) -> np.ndarray:
        if tex_id is None or tex_id < 0 or tex_id >= len(off_np):
            return np.zeros(4, np.float32)  # h == 0 -> no texture
        oy, ox = off_np[tex_id]
        h, w = size_np[tex_id]
        return np.asarray([oy, ox, h, w], np.float32)

    mat_rows = np.zeros((len(mats), MAT_ROW_W), np.float32)
    for i, m in enumerate(mats):
        r = mat_rows[i]
        r[MAT_BASE : MAT_BASE + 3] = m["base_color"]
        r[MAT_EMISSION : MAT_EMISSION + 3] = m["emission"]
        r[MAT_ROUGH] = m["roughness"]
        r[MAT_METAL] = m["metallic"]
        r[MAT_SUBSURF] = m["subsurface"]
        r[MAT_SHEEN] = m["sheen"]
        r[MAT_CLEARCOAT] = m["clearcoat"]
        r[MAT_IOR] = m["ior"]
        r[MAT_TRANSMISSION] = m["transmission"]
        r[MAT_SPECFLAG] = float(m["ideal_specular"])
        r[MAT_LIGHTFLAG] = float(m["is_light"])
        r[MAT_FILMFLAG] = float(m["is_thinfilm"])
        r[MAT_BASE_RECT : MAT_BASE_RECT + 4] = _rect(m["base_color_tex"])
        r[MAT_ROUGH_RECT : MAT_ROUGH_RECT + 4] = _rect(m["roughness_tex"])
        r[MAT_METAL_RECT : MAT_METAL_RECT + 4] = _rect(m["metallic_tex"])
        r[MAT_NORMAL_RECT : MAT_NORMAL_RECT + 4] = _rect(m["normal_tex"])
        r[MAT_BUMP_RECT : MAT_BUMP_RECT + 4] = _rect(m["bump_tex"])
        r[MAT_EMISSION_RECT : MAT_EMISSION_RECT + 4] = _rect(m["emission_tex"])

    return DeviceScene(
        atlas=atlas,
        tri_attr=jnp.asarray(tri_attr),
        mat_rows=jnp.asarray(mat_rows),
        has_base_tex=any(m["base_color_tex"] >= 0 for m in mats),
        has_mr_tex=any(
            m["roughness_tex"] >= 0 or m["metallic_tex"] >= 0 for m in mats
        ),
        has_normal_tex=any(m["normal_tex"] >= 0 for m in mats),
        has_bump_tex=any(m["bump_tex"] >= 0 for m in mats),
        has_emission_tex=any(m["emission_tex"] >= 0 for m in mats),
        has_vert_colors=bool(not np.all(scene.colors == 1.0)),
        vertices=jnp.asarray(scene.vertices),
        normals=jnp.asarray(scene.normals),
        texcoords=jnp.asarray(scene.texcoords),
        colors=jnp.asarray(scene.colors),
        tri_vidx=jnp.asarray(tri_vidx),
        tri_instance=jnp.asarray(tri_instance),
        tri_material=jnp.asarray(tri_material),
        prim_offsets=jnp.asarray(np.asarray(prim_offsets, np.uint32)),
        materials=table,
        light_prim_ids=jnp.asarray(light_prim_ids),
        light_prim_emission=jnp.asarray(light_prim_emission),
        num_lights=len(light_ids),
    )


def identity_transforms(num_instances: int) -> np.ndarray:
    return np.broadcast_to(identity_affine(), (num_instances, 3, 4)).copy()


def build_frame_scene(
    device: DeviceScene,
    transforms: Optional[jnp.ndarray] = None,
    inv_transforms: Optional[jnp.ndarray] = None,
) -> FrameScene:
    """Flatten the instanced scene to world space for this frame.

    One batched gather + affine transform over all triangles — this is the
    equivalent of the reference's per-frame full IAS rebuild
    (buildIAS, renderer.h:398-490), and it is jittable so it fuses into the
    frame step."""
    num_inst = device.prim_offsets.shape[0]
    if transforms is None:
        transforms = jnp.asarray(identity_transforms(num_inst))
    if inv_transforms is None:
        inv_transforms = jnp.asarray(identity_transforms(num_inst))

    tri_xf = transforms[device.tri_instance]  # [T,3,4]
    tri_inv = inv_transforms[device.tri_instance]
    verts_obj = device.vertices[device.tri_vidx]  # [T,3,3]
    norms_obj = device.normals[device.tri_vidx]  # [T,3,3]
    tri_verts = transform_position(tri_xf[:, None], verts_obj)
    tri_normals = transform_normal(tri_inv[:, None], norms_obj)
    return FrameScene(
        tri_verts=tri_verts,
        tri_normals=tri_normals,
        device=device,
        transforms=transforms,
        inv_transforms=inv_transforms,
    )
