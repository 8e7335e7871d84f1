"""Surface-hit payload: the wavefront analogue of the reference Payload.

The reference passes a 38-field Payload struct by pointer through OptiX
payload registers (include/kernel/Payload.h:12-42) and fills it in
__closesthit__ch from SBT material records + texture fetches. Here the
payload is a plain pytree of [R]-batched arrays, and `closest_hit` is a
fused trace+shade-fetch stage: intersect, gather triangle attributes,
interpolate, and gather the material row — XLA's analogue of the SBT record
fetch (renderer.h:655-723).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from henjou.accel.bruteforce import intersect_bruteforce, occluded_bruteforce
from henjou.math.constants import EPS_RAY, TMAX_RAY
from henjou.math.vec import normalize
from henjou.scene.scenedata import FrameScene


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Sky:
    """Environment light (reference setSky, renderer.h:802-851): either an
    equirect HDR map or a 1x1 constant-color fallback; both scaled by
    ibl_intensity at miss time. `use_ibl` is static (selects the traced
    branch, like the reference binding either texture kind)."""

    constant_color: jnp.ndarray  # [3]
    intensity: jnp.ndarray  # scalar
    use_ibl: bool = dataclasses.field(default=False, metadata=dict(static=True))
    ibl_texture: Optional[jnp.ndarray] = None  # [H,W,3] f32, equirect


class SurfaceHit(NamedTuple):
    """reference: include/kernel/Payload.h:12-42, batched over rays."""

    is_hit: jnp.ndarray  # [R] bool
    t: jnp.ndarray  # [R]
    position: jnp.ndarray  # [R,3] world
    normal: jnp.ndarray  # [R,3] world shading normal
    vert_color: jnp.ndarray  # [R,3]
    texcoord: jnp.ndarray  # [R,2]
    material_id: jnp.ndarray  # [R] i32
    basecolor: jnp.ndarray  # [R,3]
    metallic: jnp.ndarray  # [R]
    roughness: jnp.ndarray  # [R]
    subsurface: jnp.ndarray  # [R]
    sheen: jnp.ndarray  # [R]
    clearcoat: jnp.ndarray  # [R]
    ior: jnp.ndarray  # [R]
    transmission: jnp.ndarray  # [R]
    is_specular: jnp.ndarray  # [R] bool
    emission: jnp.ndarray  # [R,3]
    is_light: jnp.ndarray  # [R] bool
    is_thinfilm: jnp.ndarray  # [R] bool
    primitive_id: jnp.ndarray  # [R] i32 (global instanced tri id)
    instance_id: jnp.ndarray  # [R] i32


def eval_sky(sky: Sky, ray_d: jnp.ndarray) -> jnp.ndarray:
    """Miss-program emission (__miss__ms reconstruction, SURVEY.md §0):
    equirect IBL lookup or constant color, times intensity."""
    if sky.use_ibl and sky.ibl_texture is not None:
        from henjou.texture.ibl import sample_equirect

        col = sample_equirect(sky.ibl_texture, ray_d)
    else:
        col = jnp.broadcast_to(sky.constant_color, ray_d.shape)
    return col * sky.intensity


def closest_hit(
    frame: FrameScene,
    sky: Sky,
    ray_o: jnp.ndarray,
    ray_d: jnp.ndarray,
    tmin=EPS_RAY,
    tmax=TMAX_RAY,
    intersect_fn=None,
) -> SurfaceHit:
    """Trace + payload fill for a ray batch.

    `intersect_fn(tri_verts, o, d, tmin, tmax)` defaults to brute force and
    is swappable for the LBVH traversal (same contract).

    Gather budget (the perf-critical part on this platform — random row
    gathers cost per ROW, not per byte): one packed tri-attr row, one
    world-normal row, one packed material row; texture work (4 data
    gathers per map) only compiles in when the scene actually carries that
    map kind (DeviceScene.has_* static facts).

    Note: the reference Material carries a `specular` color slot, but the
    device Payload has no such field (Payload.h:12-42) — it never reaches
    the BSDFs, so it is dead in the reference's device path too; we follow.
    """
    from henjou.scene import scenedata as sd

    dev = frame.device
    if intersect_fn is None:
        intersect_fn = intersect_bruteforce
    hit_t, prim, u, v, is_hit = intersect_fn(frame.tri_verts, ray_o, ray_d, tmin, tmax)

    prim_safe = jnp.maximum(prim, 0)
    w0 = (1.0 - u - v)[:, None]
    w1 = u[:, None]
    w2 = v[:, None]

    # flat 9-wide row gather: one [T,9] row per lane, then column slices
    n_row = frame.tri_normals.reshape(-1, 9)[prim_safe]  # [R,9] world
    normal = normalize(
        n_row[:, 0:3] * w0 + n_row[:, 3:6] * w1 + n_row[:, 6:9] * w2
    )

    row = dev.tri_attr[prim_safe]  # [R,TRI_ROW_W] — ONE gather
    tc0 = row[:, sd.TRI_TC0 : sd.TRI_TC0 + 2]
    tc1 = row[:, sd.TRI_TC1 : sd.TRI_TC1 + 2]
    tc2 = row[:, sd.TRI_TC2 : sd.TRI_TC2 + 2]
    texcoord = tc0 * w0 + tc1 * w1 + tc2 * w2
    if dev.has_vert_colors:
        vert_color = (
            row[:, sd.TRI_COL0 : sd.TRI_COL0 + 3] * w0
            + row[:, sd.TRI_COL1 : sd.TRI_COL1 + 3] * w1
            + row[:, sd.TRI_COL2 : sd.TRI_COL2 + 3] * w2
        )
    else:
        vert_color = jnp.ones(ray_o.shape, jnp.float32)
    mat_id = row[:, sd.TRI_MAT].astype(jnp.int32)
    inst_id = row[:, sd.TRI_INST].astype(jnp.int32)

    t_for_pos = jnp.where(is_hit, hit_t, 0.0)
    position = ray_o + t_for_pos[:, None] * ray_d

    m = dev.mat_rows[mat_id]  # [R,MAT_ROW_W] — ONE gather (SBT record fetch)

    # material texture fetches (the reconstructed __closesthit__ch applies
    # SBT textures at texcoord; SURVEY.md §0): basecolor modulated by the
    # sRGB-decoded base texture; glTF metallicRoughness packs roughness in
    # G and metallic in B.
    from henjou.texture.atlas import sample_atlas_rect

    tu, tv = texcoord[:, 0], texcoord[:, 1]
    basecolor = m[:, sd.MAT_BASE : sd.MAT_BASE + 3]
    if dev.has_base_tex:
        rect = m[:, sd.MAT_BASE_RECT : sd.MAT_BASE_RECT + 4]
        basecolor = basecolor * sample_atlas_rect(dev.atlas.data, rect, tu, tv)[:, :3]
    roughness_v = m[:, sd.MAT_ROUGH]
    metallic_v = m[:, sd.MAT_METAL]
    if dev.has_mr_tex:
        rrect = m[:, sd.MAT_ROUGH_RECT : sd.MAT_ROUGH_RECT + 4]
        mr = sample_atlas_rect(dev.atlas.data, rrect, tu, tv)
        roughness_v = roughness_v * jnp.where(rrect[:, 2] > 0.0, mr[:, 1], 1.0)
        mrect = m[:, sd.MAT_METAL_RECT : sd.MAT_METAL_RECT + 4]
        mm = sample_atlas_rect(dev.atlas.data, mrect, tu, tv)
        metallic_v = metallic_v * jnp.where(mrect[:, 2] > 0.0, mm[:, 2], 1.0)

    # normal/bump mapping (SBT normal_tex/bump_tex, renderer.h:679-680,
    # 715-716): tangent frame from the triangle's UV parameterization.
    if dev.has_normal_tex or dev.has_bump_tex:
        tri_v = frame.tri_verts[prim_safe]  # [R,3,3] — one extra gather
        e1 = tri_v[:, 1] - tri_v[:, 0]
        e2 = tri_v[:, 2] - tri_v[:, 0]
        duv1 = tc1 - tc0
        duv2 = tc2 - tc0
        det_uv = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
        inv_uv = jnp.where(jnp.abs(det_uv) > 1e-12, 1.0 / det_uv, 0.0)[:, None]
        tangent = (e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) * inv_uv
        # Gram-Schmidt against the shading normal; degenerate UVs keep the
        # geometric frame
        tangent = tangent - normal * jnp.sum(tangent * normal, -1, keepdims=True)
        t_len = jnp.sqrt(jnp.maximum(jnp.sum(tangent * tangent, -1), 1e-20))
        has_frame = (t_len > 1e-8) & (jnp.abs(det_uv) > 1e-12)
        tangent = tangent / t_len[:, None]
        bitan = jnp.cross(normal, tangent)
        if dev.has_normal_tex:
            nrect = m[:, sd.MAT_NORMAL_RECT : sd.MAT_NORMAL_RECT + 4]
            nts = sample_atlas_rect(dev.atlas.data, nrect, tu, tv)[:, :3] * 2.0 - 1.0
            n_mapped = normalize(
                tangent * nts[:, 0:1] + bitan * nts[:, 1:2] + normal * nts[:, 2:3]
            )
            use = (nrect[:, 2] > 0.0) & has_frame
            normal = jnp.where(use[:, None], n_mapped, normal)
        if dev.has_bump_tex:
            brect = m[:, sd.MAT_BUMP_RECT : sd.MAT_BUMP_RECT + 4]
            bw = jnp.maximum(brect[:, 3], 1.0)
            bh = jnp.maximum(brect[:, 2], 1.0)
            h0 = sample_atlas_rect(dev.atlas.data, brect, tu, tv)[:, 0]
            hu = sample_atlas_rect(dev.atlas.data, brect, tu + 1.0 / bw, tv)[:, 0]
            hv = sample_atlas_rect(dev.atlas.data, brect, tu, tv + 1.0 / bh)[:, 0]
            n_bump = normalize(
                normal + tangent * (h0 - hu)[:, None] + bitan * (h0 - hv)[:, None]
            )
            use = (brect[:, 2] > 0.0) & has_frame
            normal = jnp.where(use[:, None], n_bump, normal)

    emission_mat = m[:, sd.MAT_EMISSION : sd.MAT_EMISSION + 3]
    if dev.has_emission_tex:
        erect = m[:, sd.MAT_EMISSION_RECT : sd.MAT_EMISSION_RECT + 4]
        emission_mat = (
            emission_mat * sample_atlas_rect(dev.atlas.data, erect, tu, tv)[:, :3]
        )
    hitf = is_hit[:, None]

    sky_emission = eval_sky(sky, ray_d)
    emission = jnp.where(hitf, emission_mat, sky_emission)

    zero3 = jnp.zeros_like(basecolor)
    return SurfaceHit(
        is_hit=is_hit,
        t=hit_t,
        position=jnp.where(hitf, position, zero3),
        normal=jnp.where(hitf, normal, zero3),
        vert_color=jnp.where(hitf, vert_color, zero3),
        texcoord=jnp.where(hitf, texcoord, jnp.zeros_like(texcoord)),
        material_id=jnp.where(is_hit, mat_id, 0),
        basecolor=jnp.where(hitf, basecolor, zero3),
        metallic=jnp.where(is_hit, metallic_v, 0.0),
        roughness=jnp.where(is_hit, roughness_v, 0.0),
        subsurface=jnp.where(is_hit, m[:, sd.MAT_SUBSURF], 0.0),
        sheen=jnp.where(is_hit, m[:, sd.MAT_SHEEN], 0.0),
        clearcoat=jnp.where(is_hit, m[:, sd.MAT_CLEARCOAT], 0.0),
        ior=jnp.where(is_hit, m[:, sd.MAT_IOR], 1.0),
        transmission=jnp.where(is_hit, m[:, sd.MAT_TRANSMISSION], 1.0),
        is_specular=is_hit & (m[:, sd.MAT_SPECFLAG] > 0.0),
        emission=emission,
        is_light=is_hit & (m[:, sd.MAT_LIGHTFLAG] > 0.0),
        is_thinfilm=is_hit & (m[:, sd.MAT_FILMFLAG] > 0.0),
        primitive_id=jnp.where(is_hit, prim, 0),
        instance_id=jnp.where(is_hit, inst_id, 0),
    )


def occluded(
    frame: FrameScene, ray_o, ray_d, tmin, tmax, occluded_fn=None
) -> jnp.ndarray:
    """Shadow-ray visibility (TraceOcculution analogue, rt.h:15-41)."""
    if occluded_fn is None:
        occluded_fn = occluded_bruteforce
    return occluded_fn(frame.tri_verts, ray_o, ray_d, tmin, tmax)
