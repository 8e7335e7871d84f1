"""Motion-compensated temporal denoising (the flow-input analogue of the
OptiX TEMPORAL denoiser kind, reference include/renderer/denoiser.h:35-40).

Covers: the world->pixel projection inverse of raygen, bilinear history
warping, and the end-to-end property that under a moving camera the
reprojected blend ghosts LESS than the unwarped blend."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest


def _cam(pos, look, fov=np.pi / 4):
    from henjou.runtime.camera import make_camera

    d = np.asarray(look, np.float32) - np.asarray(pos, np.float32)
    return make_camera(pos, d / np.linalg.norm(d), fov)


def test_project_to_pixel_inverts_raygen():
    """Points placed along pixel-center rays project back to those exact
    pixel centers (the dual-basis solve handles the reference's
    non-unit right/up when the camera pitches)."""
    from henjou.runtime.camera import camera_rays_centers, project_to_pixel

    w, h = 24, 16
    # pitched camera: direction NOT horizontal, so |right| != 1
    cam = _cam([1.0, 2.5, -4.0], [0.2, 0.4, 1.0])
    o, d = camera_rays_centers(cam, w, h)
    ts = jnp.linspace(0.5, 12.0, w * h)[:, None]
    pts = o + ts * d
    px, py, valid = project_to_pixel(cam, pts, w, h)
    iy, ix = np.divmod(np.arange(w * h), w)
    assert bool(np.all(np.asarray(valid)))
    np.testing.assert_allclose(np.asarray(px), ix + 0.5, atol=2e-3)
    np.testing.assert_allclose(np.asarray(py), iy + 0.5, atol=2e-3)


def test_project_behind_camera_invalid():
    from henjou.runtime.camera import project_to_pixel

    cam = _cam([0.0, 0.0, 0.0], [0.0, 0.0, 1.0])
    pts = jnp.asarray([[0.0, 0.0, -5.0], [0.0, 0.0, 5.0]], jnp.float32)
    _, _, valid = project_to_pixel(cam, pts, 16, 16)
    assert not bool(valid[0]) and bool(valid[1])


def test_bilinear_sample_identity_and_bounds():
    from henjou.post.denoise import _bilinear_sample

    rng = np.random.default_rng(3)
    img = jnp.asarray(rng.random((8, 12, 3), dtype=np.float32))
    yy, xx = jnp.meshgrid(
        jnp.arange(8, dtype=jnp.float32) + 0.5,
        jnp.arange(12, dtype=jnp.float32) + 0.5,
        indexing="ij",
    )
    out, inb = _bilinear_sample(img, xx, yy)
    np.testing.assert_allclose(np.asarray(out), np.asarray(img), atol=1e-6)
    assert bool(inb.all())
    _, inb2 = _bilinear_sample(img, xx - 100.0, yy)
    assert not bool(inb2.any())


def test_reprojection_beats_blend_under_camera_motion():
    """A textured plane viewed by a translating camera: warp the previous
    frame's (noise-free) output through the previous camera and compare
    against the current frame's true image. The motion-compensated
    history must align far better than the unwarped history — the ghost
    the plain blend would smear in."""
    from henjou.runtime.camera import camera_rays_centers, project_to_pixel
    from henjou.post.denoise import _bilinear_sample

    w, h = 64, 48

    def plane_image(cam):
        """Intersect pixel-center rays with the y=0 plane and shade by a
        smooth function of the hit point (world-anchored texture)."""
        o, d = camera_rays_centers(cam, w, h)
        t = -o[:, 1] / d[:, 1]
        p = o + t[:, None] * d
        col = jnp.stack(
            [
                0.5 + 0.5 * jnp.sin(1.3 * p[:, 0]),
                0.5 + 0.5 * jnp.cos(0.9 * p[:, 2]),
                0.5 + 0.5 * jnp.sin(0.7 * (p[:, 0] + p[:, 2])),
            ],
            axis=1,
        )
        return (
            p.reshape(h, w, 3),
            col.reshape(h, w, 3),
            (t > 0).reshape(h, w),
        )

    cam_prev = _cam([0.0, 3.0, -6.0], [0.0, 0.0, 0.0])
    cam_cur = _cam([0.6, 3.0, -6.0], [0.6, 0.0, 0.0])  # pure truck right

    _, img_prev, _ = plane_image(cam_prev)
    pos_cur, img_cur, hitm = plane_image(cam_cur)

    px, py, infront = project_to_pixel(cam_prev, pos_cur.reshape(-1, 3), w, h)
    warped, inb = _bilinear_sample(
        img_prev, px.reshape(h, w), py.reshape(h, w)
    )
    ok = (
        np.asarray(inb)[..., 0].astype(bool)
        & np.asarray(infront).reshape(h, w)
        & np.asarray(hitm)
    )
    err_warped = np.abs(np.asarray(warped) - np.asarray(img_cur))[ok].mean()
    err_unwarped = np.abs(np.asarray(img_prev) - np.asarray(img_cur))[ok].mean()
    assert err_warped < 0.02, err_warped  # sub-pixel after warping
    assert err_warped < err_unwarped * 0.25, (err_warped, err_unwarped)


@pytest.mark.slow
def test_denoise_temporal_reprojected_rejects_disocclusion():
    """Lanes whose reprojection is invalid (off-screen / miss) must get
    ZERO history weight — identical to the pure spatial filter there."""
    from henjou.post.denoise import (
        denoise_atrous,
        denoise_temporal_reprojected,
    )

    rng = np.random.default_rng(11)
    h, w = 16, 16
    color = jnp.asarray(rng.random((h, w, 3), dtype=np.float32))
    albedo = jnp.ones((h, w, 3), jnp.float32) * 0.5
    normal = jnp.zeros((h, w, 3), jnp.float32).at[..., 2].set(1.0)
    prev = jnp.ones((h, w, 3), jnp.float32) * 7.0  # poisoned history
    yy, xx = jnp.meshgrid(
        jnp.arange(h, dtype=jnp.float32) + 0.5,
        jnp.arange(w, dtype=jnp.float32) + 0.5,
        indexing="ij",
    )
    out = denoise_temporal_reprojected(
        color, albedo, normal, prev, albedo, normal,
        xx, yy, jnp.zeros((h, w), bool),  # reproject_valid = all False
    )
    spatial = denoise_atrous(color, albedo, normal)
    np.testing.assert_allclose(np.asarray(out), np.asarray(spatial), atol=1e-6)
    # and with valid reprojection + agreeing guides, history IS used —
    # but the TAA-style neighborhood clamp bounds the poisoned 7.0
    # history to the 3x3 max of the current spatial estimate, so the
    # pull is real yet the output never exceeds the local range
    from henjou.post.denoise import _maxpool3

    out2 = denoise_temporal_reprojected(
        color, albedo, normal, prev, albedo, normal,
        xx, yy, jnp.ones((h, w), bool),
    )
    assert float(jnp.abs(out2 - spatial).max()) > 0.1
    assert float((out2 - _maxpool3(spatial)).max()) <= 1e-6


@pytest.mark.parametrize("scene_name", ["cornell", "gallery"])
def test_depth_probe_matches_closest_hit(scene_name):
    """The temporal depth probe (one pixel-center closest-hit pass through
    the backend's route, or brute force for tiny scenes) must agree with a
    brute-force closest_hit on the same rays."""
    from henjou.accel.lbvh import build_lbvh
    from henjou.integrator.payload import Sky, closest_hit
    from henjou.runtime.camera import camera_rays_centers, make_camera
    from henjou.runtime.renderer import _temporal_depth_probe
    from henjou.scene.scenedata import build_device_scene, build_frame_scene
    from henjou.scene.testscenes import cornell_box_scene, sphere_gallery_scene

    if scene_name == "cornell":
        scene, cam = cornell_box_scene(), make_camera((0, 0, -4.5), (0, 0, 1), np.radians(45.0))
    else:
        scene = sphere_gallery_scene()
        cam = make_camera((0.0, 1.2, -9.0), (0.0, -0.05, 1.0), np.radians(45.0))
    frame = jax.jit(build_frame_scene)(build_device_scene(scene), None, None)
    accel = None if scene_name == "cornell" else jax.jit(build_lbvh)(frame.tri_verts)
    sky = Sky(constant_color=jnp.zeros(3), intensity=jnp.asarray(1.0))
    w, h = 20, 12
    pos, hit = _temporal_depth_probe(frame, sky, cam, accel, w, h)
    o, d = camera_rays_centers(cam, w, h)
    ref = closest_hit(frame, sky, o, d)
    assert pos.shape == (h, w, 3) and hit.shape == (h, w)
    ref_hit = np.asarray(ref.is_hit).reshape(h, w)
    assert (np.asarray(hit) == ref_hit).all() and ref_hit.any()
    np.testing.assert_allclose(
        np.asarray(pos)[ref_hit],
        np.asarray(ref.position).reshape(h, w, 3)[ref_hit],
        rtol=1e-5, atol=1e-5,
    )


def test_temporal_accumulate_merges_counts_and_variance():
    """Identity reprojection + agreeing guides: the merged mean is the
    count-weighted average, variance drops accordingly, and the history
    count is capped at cap*n_c. Disoccluded pixels keep the current
    frame untouched."""
    from henjou.post.denoise import temporal_accumulate

    h, w = 8, 12
    rng = np.random.default_rng(7)
    albedo = jnp.asarray(rng.random((h, w, 3), dtype=np.float32))
    normal = jnp.asarray(rng.random((h, w, 3), dtype=np.float32))
    cur = jnp.full((h, w, 3), 2.0, jnp.float32)
    hist = jnp.full((h, w, 3), 2.0, jnp.float32)
    var = jnp.full((h, w), 0.1, jnp.float32)
    pvar = jnp.full((h, w), 0.05, jnp.float32)
    cnt = jnp.full((h, w), 8.0, jnp.float32)
    pcnt = jnp.full((h, w), 8.0, jnp.float32)
    yy, xx = jnp.meshgrid(
        jnp.arange(h, dtype=jnp.float32) + 0.5,
        jnp.arange(w, dtype=jnp.float32) + 0.5,
        indexing="ij",
    )
    valid = jnp.ones((h, w), bool)
    merged, var_m, n_eff = temporal_accumulate(
        cur, var, cnt, albedo, normal,
        hist, pvar, pcnt, albedo, normal, xx, yy, valid,
    )
    # equal counts, equal means -> mean unchanged, n_eff = 16,
    # var = (64*0.1 + 64*0.05)/256 = 0.0375
    np.testing.assert_allclose(np.asarray(merged), 2.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(n_eff), 16.0, atol=1e-4)
    np.testing.assert_allclose(np.asarray(var_m), 0.0375, atol=1e-5)

    # history count far above the cap: n_h clamps to cap*n_c = 32
    merged2, _, n_eff2 = temporal_accumulate(
        cur, var, cnt, albedo, normal,
        hist, pvar, jnp.full((h, w), 1000.0, jnp.float32),
        albedo, normal, xx, yy, valid,
    )
    np.testing.assert_allclose(np.asarray(n_eff2), 40.0, atol=1e-3)

    # disocclusion (valid=0 everywhere): current frame passes through
    merged3, var3, n3 = temporal_accumulate(
        cur, var, cnt, albedo, normal,
        hist + 5.0, pvar, pcnt, albedo, normal, xx, yy,
        jnp.zeros((h, w), bool),
    )
    np.testing.assert_allclose(np.asarray(merged3), 2.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(n3), 8.0, atol=1e-4)
    np.testing.assert_allclose(np.asarray(var3), 0.1, atol=1e-5)


def test_temporal_accumulate_neighborhood_clamp():
    """A ghosted history (radiance moved, guides identical — the
    view-dependent case) is clamped to the 3x3 range of the current raw
    mean, so the merged value stays within the local range."""
    from henjou.post.denoise import _maxpool3, temporal_accumulate

    h, w = 8, 8
    rng = np.random.default_rng(11)
    albedo = jnp.asarray(rng.random((h, w, 3), dtype=np.float32))
    normal = jnp.asarray(rng.random((h, w, 3), dtype=np.float32))
    cur = jnp.asarray(rng.random((h, w, 3), dtype=np.float32))
    hist = jnp.full((h, w, 3), 50.0, jnp.float32)  # poisoned history
    var = jnp.full((h, w), 0.1, jnp.float32)
    cnt = jnp.full((h, w), 8.0, jnp.float32)
    yy, xx = jnp.meshgrid(
        jnp.arange(h, dtype=jnp.float32) + 0.5,
        jnp.arange(w, dtype=jnp.float32) + 0.5,
        indexing="ij",
    )
    merged, _, _ = temporal_accumulate(
        cur, var, cnt, albedo, normal,
        hist, var, cnt, albedo, normal, xx, yy,
        jnp.ones((h, w), bool),
    )
    # clamp bound is variance-aware: local 3x3 range + 3 sigma of the
    # current pixel's noise (loose where noisy, tight where converged)
    bound = _maxpool3(cur) + 3.0 * jnp.sqrt(var)[..., None]
    assert float((merged - bound).max()) <= 1e-5
    # converged pixel (var -> 0): the ghost is fully clamped to range
    merged0, _, _ = temporal_accumulate(
        cur, jnp.zeros((h, w), jnp.float32), cnt, albedo, normal,
        hist, var, cnt, albedo, normal, xx, yy,
        jnp.ones((h, w), bool),
    )
    assert float((merged0 - _maxpool3(cur)).max()) <= 1e-5


def test_project_to_pixel_nonorthogonal_reference_basis():
    """The contest/gltf camera keeps WORLD up=(0,1,0) as the film
    vertical while the direction pitches (reference renderer.h camera:
    up is not orthogonalized against direction) — the projection must
    invert raygen for that basis too. Regression for the ~200 px
    vertical reprojection error that silently zeroed the temporal
    history gate (BASELINE.md round-5 temporal ledger)."""
    from henjou.runtime.camera import (
        camera_rays_centers, make_camera, project_to_pixel,
    )

    d = np.asarray([0.0, -0.27, 0.96], np.float32)
    d /= np.linalg.norm(d)
    cam = make_camera(
        [0.0, 6.0, -16.5], d, np.radians(40.0),
        up=[0.0, 1.0, 0.0], right=np.cross(d, [0.0, 1.0, 0.0]),
    )
    assert abs(float(cam.up @ cam.direction)) > 0.1  # genuinely skewed
    w, h = 48, 28
    o, rd = camera_rays_centers(cam, w, h)
    ts = jnp.linspace(0.5, 30.0, w * h)[:, None]
    px, py, valid = project_to_pixel(cam, o + ts * rd, w, h)
    iy, ix = np.divmod(np.arange(w * h), w)
    assert bool(np.all(np.asarray(valid)))
    np.testing.assert_allclose(np.asarray(px), ix + 0.5, atol=2e-3)
    np.testing.assert_allclose(np.asarray(py), iy + 0.5, atol=2e-3)
