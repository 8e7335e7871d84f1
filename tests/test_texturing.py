"""Hit-time texture application: normal maps, bump maps, emission
textures, and the packed-row payload fill (reference SBT fill,
renderer.h:655-723, applied in the reconstructed __closesthit__ch)."""

import jax.numpy as jnp
import numpy as np
import pytest

from henjou.integrator.payload import Sky, closest_hit
from henjou.scene.scenedata import (
    SceneData,
    build_device_scene,
    build_frame_scene,
    make_material,
)
from henjou.texture.texture import Texture, TexType


def _quad_scene(material, textures):
    """Unit quad at z=0 facing -z, texcoords spanning [0,1]^2."""
    verts = np.asarray(
        [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, -1, 0], [1, 1, 0], [-1, 1, 0]],
        np.float32,
    )
    tcs = np.asarray(
        [[0, 0], [1, 0], [1, 1], [0, 0], [1, 1], [0, 1]], np.float32
    )
    normals = np.asarray([[0, 0, -1]] * 6, np.float32)
    return SceneData(
        vertices=verts,
        indices=np.arange(6, dtype=np.uint32),
        material_ids=np.asarray([0, 0], np.uint32),
        normals=normals,
        texcoords=tcs,
        colors=None,
        materials=[material],
        textures=textures,
    )


def _first_hit(scene, n=4):
    dev = build_device_scene(scene)
    frame = build_frame_scene(dev)
    sky = Sky(constant_color=jnp.zeros(3), intensity=jnp.asarray(1.0))
    o = jnp.tile(jnp.asarray([[0.25, 0.1, -3.0]], jnp.float32), (n, 1))
    d = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32), (n, 1))
    return closest_hit(frame, sky, o, d)


def _const_tex(rgb, name="t", size=4):
    data = np.zeros((size, size, 4), np.float32)
    data[..., :3] = np.asarray(rgb, np.float32)
    data[..., 3] = 1.0
    return Texture(name, data, TexType.NON_COLOR)


@pytest.mark.slow
def test_normal_map_perturbs_shading_normal():
    # tangent-space normal tilted toward +u: n_ts = (0.6, 0, 0.8)
    tex = _const_tex([(0.6 + 1) / 2, 0.5, (0.8 + 1) / 2])
    mat = make_material("nm", normal_tex=0)
    hit = _first_hit(_quad_scene(mat, [tex]))
    n = np.asarray(hit.normal)[0]
    flat = np.asarray([0.0, 0.0, -1.0])
    assert np.asarray(hit.is_hit).all()
    # perturbed away from the flat geometric normal, by the right amount
    assert not np.allclose(n, flat, atol=0.05)
    assert abs(np.dot(n, flat) - 0.8) < 0.05  # cos(tilt) == n_ts.z
    # tilt lies along the +u tangent direction (world +x for this quad)
    assert abs(abs(n[0]) - 0.6) < 0.05
    np.testing.assert_allclose(np.linalg.norm(n), 1.0, atol=1e-5)


def test_flat_normal_map_is_identity():
    tex = _const_tex([0.5, 0.5, 1.0])  # n_ts = (0,0,1)
    mat = make_material("nm", normal_tex=0)
    hit = _first_hit(_quad_scene(mat, [tex]))
    n = np.asarray(hit.normal)[0]
    np.testing.assert_allclose(n, [0.0, 0.0, -1.0], atol=1e-4)


def test_bump_map_gradient_tilts_normal():
    # height ramp along u: h(u,v) = u -> normal tilts against +u tangent
    size = 16
    data = np.zeros((size, size, 4), np.float32)
    ramp = (np.arange(size, dtype=np.float32) + 0.5) / size
    data[..., 0] = ramp[None, :]
    data[..., 3] = 1.0
    tex = Texture("bump", data, TexType.NON_COLOR)
    mat = make_material("bm", bump_tex=0)
    hit = _first_hit(_quad_scene(mat, [tex]))
    n = np.asarray(hit.normal)[0]
    flat = np.asarray([0.0, 0.0, -1.0])
    assert not np.allclose(n, flat, atol=1e-3)
    assert abs(n[1]) < 1e-4  # no v-gradient -> no bitangent tilt


def test_emission_texture_modulates_emission():
    tex = _const_tex([0.25, 0.5, 1.0])
    mat = make_material(
        "em", emission=(2.0, 2.0, 2.0), emission_tex=0, is_light=True
    )
    hit = _first_hit(_quad_scene(mat, [tex]))
    np.testing.assert_allclose(
        np.asarray(hit.emission)[0], [0.5, 1.0, 2.0], atol=1e-5
    )
    assert np.asarray(hit.is_light).all()


def test_packed_rows_match_material_table():
    """The packed material row carries the same values as the SoA table."""
    mat = make_material(
        "m", base_color=(0.2, 0.4, 0.6), roughness=0.3, metallic=0.7,
        sheen=0.1, clearcoat=0.2, ior=1.33, transmission=0.5,
    )
    hit = _first_hit(_quad_scene(mat, []))
    np.testing.assert_allclose(np.asarray(hit.basecolor)[0], [0.2, 0.4, 0.6], atol=1e-6)
    assert abs(float(hit.roughness[0]) - 0.3) < 1e-6
    assert abs(float(hit.metallic[0]) - 0.7) < 1e-6
    assert abs(float(hit.sheen[0]) - 0.1) < 1e-6
    assert abs(float(hit.clearcoat[0]) - 0.2) < 1e-6
    assert abs(float(hit.ior[0]) - 1.33) < 1e-6
    assert abs(float(hit.transmission[0]) - 0.5) < 1e-6
