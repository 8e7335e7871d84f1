"""Render modes, denoiser, camera animation, config snapshot
(reference features: render_option.h:38-43, denoiser.h, renderer.h:1149-1169)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from henjou.runtime.options import RenderMode, RenderOption, load_render_option
from henjou.runtime.renderer import Renderer
from henjou.scene.testscenes import cornell_box_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mk_renderer(mode=RenderMode.DEFAULT, spp=8, size=32, **kw):
    r = Renderer(
        option=RenderOption(
            image_width=size,
            image_height=size,
            max_spp=spp,
            spp_batch=min(spp, 8),
            camera_position=(0.0, 0.0, -4.5),
            camera_direction=(0.0, 0.0, 1.0),
            scene_sky_default=(0.0, 0.0, 0.0),
            render_mode=mode,
            **kw,
        )
    )
    r.set_scene(cornell_box_scene())
    r.build()
    return r


@pytest.mark.slow
def test_denoise_mode_reduces_variance(tmp_path):
    import dataclasses

    r = _mk_renderer(RenderMode.DENOISE, spp=8, size=32)
    r.option = dataclasses.replace(r.option, image_directory=str(tmp_path), image_name="dn")
    aovs = r.render_frame(0)
    noisy = aovs["color"]
    out = r._finalize(aovs)
    assert out.shape == noisy.shape
    assert np.isfinite(out).all()
    # interior variance drops under the a-trous filter
    assert np.var(out[8:-8, 8:-8]) < np.var(noisy[8:-8, 8:-8])


@pytest.mark.slow
def test_upscale2x_mode_doubles_resolution(tmp_path):
    import dataclasses

    r = _mk_renderer(RenderMode.DENOISE_UPSCALE2X, spp=4, size=32)
    r.option = dataclasses.replace(
        r.option, image_directory=str(tmp_path), image_name="up"
    )
    written = r.initialize_and_render()
    from henjou.post.png import read_png

    img = read_png(written[0])
    # renders at half res (16x16), upscales back to 32x32 (renderer.h:1096-1120)
    assert img.shape[:2] == (32, 32)


@pytest.mark.slow
def test_temporal_mode_reduces_flicker(tmp_path):
    """DenoiseTemporal (denoiser.h:37 TEMPORAL kind): across two frames of
    a static scene rendered with different sample sets, the temporal output
    flickers less than independently denoised frames."""
    import dataclasses

    from henjou.post.denoise import denoise_atrous

    r = _mk_renderer(RenderMode.DENOISE_TEMPORAL, spp=4, size=32)
    r.option = dataclasses.replace(
        r.option, image_directory=str(tmp_path), image_name="tmp"
    )
    # two frames, static scene; frame index seeds differ -> different noise
    aovs0 = r.render_frame(0)
    aovs1 = r.render_frame(1)
    # consecutive frame indices: _finalize only reuses temporal history
    # for frame == prev_frame + 1 (unknown frames restart spatially)
    out0 = r._finalize(aovs0, frame=0)
    out1 = r._finalize(aovs1, frame=1)
    temporal_flicker = np.abs(out1 - out0).mean()

    ind0 = np.asarray(denoise_atrous(
        jnp.asarray(aovs0["color"]), jnp.asarray(aovs0["albedo"]),
        jnp.asarray(aovs0["normal"])))
    ind1 = np.asarray(denoise_atrous(
        jnp.asarray(aovs1["color"]), jnp.asarray(aovs1["albedo"]),
        jnp.asarray(aovs1["normal"])))
    independent_flicker = np.abs(ind1 - ind0).mean()

    assert np.isfinite(out1).all()
    assert temporal_flicker < independent_flicker * 0.6, (
        temporal_flicker, independent_flicker
    )


def test_debug_mode_outputs_four_aovs(tmp_path):
    import dataclasses

    r = _mk_renderer(RenderMode.DEBUG, spp=1, size=16)
    r.option = dataclasses.replace(
        r.option, image_directory=str(tmp_path), image_name="dbg"
    )
    written = r.initialize_and_render()
    names = [os.path.basename(w) for w in written]
    for key in ("position", "basecolor", "normal", "texcoord"):
        assert any(key in n for n in names), names


def test_camera_animation_drives_camera():
    from henjou.scene.animation import Animation, AnimationTrack

    r = _mk_renderer(spp=1, size=8, allow_camera_animation=True)
    # quarter-turn around Y between t=0 and t=1, plus translation
    anim = Animation()
    anim.translation = AnimationTrack(keys=[0.0, 1.0], values=[[0, 0, 0], [2, 0, 0]])
    anim.rotation = AnimationTrack(
        keys=[0.0, 1.0],
        values=[[0, 0, 0, 1], [0, 0.7071068, 0, 0.7071068]],
    )
    r.scene.animations = [anim]
    r.scene.camera_animation_id = 0

    cam0 = r._frame_camera(0.0)
    cam1 = r._frame_camera(1.0)
    np.testing.assert_allclose(np.asarray(cam0.position), [0, 0, -4.5], atol=1e-5)
    # position goes through the FULL TRS affine incl. rotation
    # (renderer.h:1154-1159): R(90deg@Y)*(0,0,-4.5) + T(2,0,0) = (-2.5,0,0)
    np.testing.assert_allclose(np.asarray(cam1.position), [-2.5, 0, 0], atol=1e-4)
    # direction rotated 90 degrees about Y: +z -> +x
    np.testing.assert_allclose(np.asarray(cam1.direction), [1, 0, 0], atol=1e-4)


def test_save_render_option_snapshot(tmp_path, monkeypatch):
    doc = json.load(open(os.path.join(ROOT, "scenes", "cornelbox_option.json")))
    doc["Option"]["save_renderOption"] = True
    p = tmp_path / "opt.json"
    p.write_text(json.dumps(doc))
    monkeypatch.chdir(tmp_path)
    load_render_option(str(p))
    snaps = [f for f in os.listdir(tmp_path) if f.startswith("renderoption")]
    assert snaps, "config snapshot not written"


@pytest.mark.slow
def test_golden_cornell_regression():
    """Deterministic low-spp Cornell against a checked-in golden image:
    catches any unintended change to sampling, shading or integration."""
    from henjou.post.png import read_png, write_png
    from henjou.post.srgb import float_to_srgb_u8

    r = _mk_renderer(spp=16, size=48)
    img = r.render_frame(0)["color"]
    u8 = np.asarray(float_to_srgb_u8(jnp.asarray(img)))
    golden_path = os.path.join(ROOT, "tests", "golden", "cornell_48_mis16.png")
    if os.environ.get("HENJOU_REGEN_GOLDEN") == "1":
        os.makedirs(os.path.dirname(golden_path), exist_ok=True)
        write_png(golden_path, u8)
    # The golden is PINNED (checked in). A missing golden is a failure, not
    # an invitation to self-bless a possibly-broken tree
    # (regenerate deliberately with HENJOU_REGEN_GOLDEN=1).
    assert os.path.exists(golden_path), "pinned golden image missing"
    golden = read_png(golden_path)[..., :3]
    rmse = np.sqrt(((u8.astype(np.float32) - golden.astype(np.float32)) ** 2).mean())
    assert rmse < 2.0, f"golden mismatch: RMSE {rmse}"


@pytest.mark.slow
def test_wavefront_film_chunking_matches_single_chunk(monkeypatch):
    """Renderer-level pixel chunking (film scatter size-cliff fix,
    FILM_CHUNK_PIXELS): a frame rendered in 4 chunks must match the
    whole-film render to fp add-order."""
    r = _mk_renderer(spp=4, size=32, engine="wavefront")
    whole = r.render_frame(0)
    monkeypatch.setattr(Renderer, "FILM_CHUNK_PIXELS", 256)
    r2 = _mk_renderer(spp=4, size=32, engine="wavefront")
    chunked = r2.render_frame(0)
    np.testing.assert_allclose(
        chunked["color"], whole["color"], rtol=1e-6, atol=1e-7
    )
    assert chunked["spp_done"] == whole["spp_done"]


def test_animation_budget_split_across_frames(tmp_path, monkeypatch):
    """The time budget is ANIMATION-wide (renderer.h:1073,1309): the
    per-frame deadline must be remaining/frames_left, not the whole
    remaining budget — otherwise frame 0 spends everything and each
    later frame's minimum spp batch overshoots."""
    import dataclasses

    from henjou.runtime import renderer as rmod

    r = _mk_renderer(RenderMode.DEFAULT, spp=8, size=16)
    r.option = dataclasses.replace(
        r.option, image_directory=str(tmp_path), image_name="bud",
        start_frame=0, end_frame=3, time_limit=1.5,  # 90 s budget
    )

    clock = {"t": 1000.0}
    monkeypatch.setattr(rmod.time, "monotonic", lambda: clock["t"])

    seen = []

    def fake_render_frame(self, frame, deadline=None, checkpoint_path=None):
        seen.append(deadline)
        # frame 0 finishes early (10 s); later frames use their full slice
        dt = 10.0 if frame == 0 else deadline
        clock["t"] += dt
        img = np.zeros((4, 4, 3), np.float32)
        return {
            "color": img, "albedo": img, "normal": img, "spp_done": 1,
            "render_s": dt,  # all wall time was rendering: zero overhead
        }

    monkeypatch.setattr(Renderer, "render_frame", fake_render_frame)
    r.initialize_and_render()

    assert len(seen) == 3
    # frame 0 is under-allocated x0.6 (finalize overhead unknown yet)
    np.testing.assert_allclose(seen[0], 0.6 * 90.0 / 3)
    np.testing.assert_allclose(seen[1], (90.0 - 10.0) / 2)  # early finish rolls over
    np.testing.assert_allclose(seen[2], 90.0 - 10.0 - seen[1])


def test_animation_budget_reserves_frame_overhead(tmp_path, monkeypatch):
    """Non-render overhead (finalize/denoise/PNG) measured on frame k is
    reserved off frame k+1's deadline, so the whole animation lands
    inside time_limit*60 even though the render loop can't see the
    finalize cost (a 300 s contest run once overshot to 378 s)."""
    import dataclasses

    from henjou.runtime import renderer as rmod

    r = _mk_renderer(RenderMode.DEFAULT, spp=8, size=16)
    r.option = dataclasses.replace(
        r.option, image_directory=str(tmp_path), image_name="bud",
        start_frame=0, end_frame=3, time_limit=1.5,  # 90 s budget
    )

    clock = {"t": 1000.0}
    monkeypatch.setattr(rmod.time, "monotonic", lambda: clock["t"])

    seen = []

    def fake_render_frame(self, frame, deadline=None, checkpoint_path=None):
        seen.append(deadline)
        clock["t"] += deadline  # renders its full slice...
        clock["t"] += 5.0       # ...then 5 s of unseen finalize overhead
        img = np.zeros((4, 4, 3), np.float32)
        return {
            "color": img, "albedo": img, "normal": img, "spp_done": 1,
            "render_s": deadline,
        }

    monkeypatch.setattr(Renderer, "render_frame", fake_render_frame)
    r.initialize_and_render()

    assert len(seen) == 3
    # frame 0: overhead not yet known -> x0.6 under-allocation
    np.testing.assert_allclose(seen[0], 0.6 * 90.0 / 3)
    # frame 1: 67 s left, reserve 5 s overhead for each remaining frame
    np.testing.assert_allclose(seen[1], (90.0 - 23.0 - 2 * 5.0) / 2)
    # frame 2: 33.5 s left, reserve one 5 s overhead
    np.testing.assert_allclose(seen[2], 90.0 - 23.0 - 33.5 - 5.0)
    # the whole animation fits the 90 s budget
    assert clock["t"] - 1000.0 <= 90.0 + 1e-6


@pytest.mark.slow
def test_first_batch_sized_to_fit_tight_deadline():
    """A carried per-spp cost estimate (from the previous frame) sizes
    the indivisible FIRST batch down to fit a tight deadline: after
    frame 0's finalize overhead eats the budget, frame 1 renders ~1 spp
    instead of a full spp batch that would overshoot a 300 s contest
    budget.

    Downsizing only picks spp variants ALREADY compiled this process
    (spp is a static jit arg; compiling a fresh variant can cost more
    than just running the compiled batch)."""
    # masked engine (CPU auto-resolution)
    r = _mk_renderer(RenderMode.DEFAULT, spp=8, size=16)
    r._est_spp_s = 1000.0  # "each spp takes 1000 s"
    r._spp_sizes_masked = {1, 8}  # a 1-spp variant is compiled
    aovs = r.render_frame(0, deadline=1.0)
    assert aovs["spp_done"] == 1

    # without a compiled small variant, the full batch runs (compile
    # would dominate any fit-sized first batch)
    r1 = _mk_renderer(RenderMode.DEFAULT, spp=8, size=16)
    r1._est_spp_s = 1000.0
    aovs1 = r1.render_frame(0, deadline=1.0)
    assert aovs1["spp_done"] == 8

    # wavefront engine
    import dataclasses

    r2 = _mk_renderer(RenderMode.DEFAULT, spp=8, size=16)
    # single device: a sharded step's smallest batch is one spp per device
    r2.option = dataclasses.replace(r2.option, engine="wavefront", multichip="off")
    r2._est_spp_chunk = 1000.0
    r2._spp_sizes = {1, 8}
    aovs2 = r2.render_frame(0, deadline=1.0)
    assert aovs2["spp_done"] == 1
