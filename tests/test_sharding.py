"""Multi-chip sharding tests on the virtual 8-device CPU mesh
(SURVEY.md §4: same scene on 1 vs N devices, bounded difference)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)


def _flagship(width=16, height=16, max_depth=3):
    from henjou.accel.lbvh import build_lbvh
    from henjou.accel.traverse import make_bvh_intersector
    from henjou.integrator.mis import mis
    from henjou.integrator.payload import Sky
    from henjou.runtime.camera import camera_rays, make_camera
    from henjou.sampling.cmj import make_cmj_state
    from henjou.scene.scenedata import build_device_scene, build_frame_scene
    from henjou.scene.testscenes import sphere_gallery_scene

    dev = build_device_scene(sphere_gallery_scene())
    frame = build_frame_scene(dev)
    bvh = build_lbvh(frame.tri_verts)
    intersect_fn, occluded_fn = make_bvh_intersector(bvh)
    sky = Sky(
        constant_color=jnp.asarray([0.3, 0.4, 0.55]), intensity=jnp.asarray(1.0)
    )
    cam = make_camera((0.0, 1.2, -9.0), (0.0, -0.05, 1.0), np.radians(45.0))
    lanes = width * height

    def render_one_spp(spp_idx):
        pix = jnp.arange(lanes, dtype=jnp.uint32)
        st = make_cmj_state(
            jnp.broadcast_to(jnp.asarray(spp_idx, jnp.uint32), (lanes,)), pix, 7
        )
        o, d, st = camera_rays(cam, width, height, pix, st)
        res = mis(
            frame, sky, o, d, st,
            intersect_fn=intersect_fn, occluded_fn=occluded_fn,
            max_depth=max_depth,
        )
        return res.lte, res.aov_albedo, res.aov_normal

    return render_one_spp


@pytest.mark.slow
def test_spp_sharded_matches_sequential():
    """8 spp rendered as one sharded step (one spp per chip, psum over the
    mesh) must equal the sequential 8-spp average on one device."""
    from jax.sharding import Mesh

    from henjou.runtime.sharding import spp_sharded_step

    render_one_spp = _flagship()
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("d",))
    step = spp_sharded_step(render_one_spp, mesh)
    c_sharded, a_sharded, n_sharded = step(jnp.uint32(0))

    seq = [render_one_spp(jnp.uint32(k))[0] for k in range(8)]
    c_seq = sum(np.asarray(x) for x in seq) / 8.0

    np.testing.assert_allclose(np.asarray(c_sharded), c_seq, rtol=1e-5, atol=1e-6)


@pytest.mark.slow
def test_wavefront_sharded_matches_unsharded():
    """Device k renders its own spp slice with the refilling wavefront
    engine; the psum of partial films must equal the single-pool render of
    all samples."""
    from jax.sharding import Mesh

    from henjou.bsdf.dispatch import bsdf_eval, bsdf_pdf, make_bsdf_sampler
    from henjou.integrator.payload import Sky
    from henjou.integrator.wavefront import wavefront_render
    from henjou.runtime.camera import make_camera
    from henjou.runtime.sharding import wavefront_sharded_step
    from henjou.scene.scenedata import build_device_scene, build_frame_scene
    from henjou.scene.testscenes import cornell_box_scene

    dev = build_device_scene(cornell_box_scene())
    frame = build_frame_scene(dev)
    sky = Sky(constant_color=jnp.zeros(3), intensity=jnp.asarray(1.0))
    cam = make_camera((0, 0, -4.5), (0, 0, 1), np.radians(45.0))
    w = h = 8
    bs = make_bsdf_sampler(None)
    beval = lambda hit, wo, wi: bsdf_eval(hit, wo, wi, None)
    spp_per_dev = 1

    def wf(spp_offset):
        return wavefront_render(
            frame, sky, cam, w, h, spp_per_dev, bs,
            bsdf_eval=beval, bsdf_pdf=bsdf_pdf, integrator="mis",
            seed=0, lanes=64, max_depth=3, spp_offset=spp_offset,
        )

    mesh = Mesh(np.asarray(jax.devices()[:8]), ("d",))
    step = wavefront_sharded_step(wf, mesh, spp_per_dev)
    c8, a8, n8, tr8, m2_8, cnt8 = step(jnp.uint32(0))

    ref = wavefront_render(
        frame, sky, cam, w, h, 8, bs,
        bsdf_eval=beval, bsdf_pdf=bsdf_pdf, integrator="mis",
        seed=0, lanes=64, max_depth=3,
    )
    np.testing.assert_allclose(
        np.asarray(c8), np.asarray(ref.color), rtol=1e-5, atol=1e-6
    )
    assert abs(float(tr8) - float(ref.n_traces)) < 1e-3
    # variance/count film columns reduce identically over the mesh
    np.testing.assert_allclose(
        np.asarray(m2_8), np.asarray(ref.m2), rtol=1e-5, atol=1e-6
    )
    assert (np.asarray(cnt8) == np.asarray(ref.count)).all()


@pytest.mark.slow
def test_tile_sharded_matches_unsharded():
    from jax.sharding import Mesh

    from henjou.runtime.sharding import tile_sharded_step

    render_one = _flagship()

    # adapt: render specific pixels at one spp
    from henjou.accel.lbvh import build_lbvh
    from henjou.accel.traverse import make_bvh_intersector
    from henjou.integrator.mis import mis
    from henjou.integrator.payload import Sky
    from henjou.runtime.camera import camera_rays, make_camera
    from henjou.sampling.cmj import make_cmj_state
    from henjou.scene.scenedata import build_device_scene, build_frame_scene
    from henjou.scene.testscenes import cornell_box_scene

    dev = build_device_scene(cornell_box_scene())
    frame = build_frame_scene(dev)
    sky = Sky(constant_color=jnp.zeros(3), intensity=jnp.asarray(1.0))
    cam = make_camera((0.0, 0.0, -4.5), (0.0, 0.0, 1.0), np.radians(45.0))

    def render_pixels(pixel_idx, spp_idx):
        st = make_cmj_state(
            jnp.broadcast_to(spp_idx.astype(jnp.uint32), pixel_idx.shape),
            pixel_idx,
            3,
        )
        o, d, st = camera_rays(cam, 16, 16, pixel_idx, st)
        res = mis(frame, sky, o, d, st, max_depth=3)
        return res.lte, res.aov_albedo, res.aov_normal

    mesh = Mesh(np.asarray(jax.devices()[:8]), ("d",))
    step = tile_sharded_step(render_pixels, mesh)
    pix = jnp.arange(256, dtype=jnp.uint32)
    c_sharded, _, _ = step(pix, jnp.uint32(0))
    c_ref, _, _ = jax.jit(render_pixels)(pix, jnp.uint32(0))
    np.testing.assert_allclose(
        np.asarray(c_sharded), np.asarray(c_ref), rtol=1e-5, atol=1e-6
    )


@pytest.mark.slow
def test_graft_entry_contract():
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", os.path.join(root, "__graft_entry__.py")
    )
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    fn, args = m.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (32 * 32, 3)
    assert np.isfinite(np.asarray(out)).all()
    m.dryrun_multichip(8)
