"""Adaptive sample allocation (wavefront engine list mode + renderer).

The engine's adaptive mode must be a pure RESLICING of the uniform
sample stream: pixel p's first n samples are the same CMJ point set no
matter how passes allocated them, so flat counts reproduce the uniform
render bitwise and split passes with sample_base continuation sum to the
single-pass film. The renderer's variance-driven loop must produce a
non-flat allocation and agree with the uniform render within noise.

Reference counterpart: none — the reference brute-forces uniform
max_spp (renderer.h:1183,1241); this is the quality-per-second
lever (round-3 VERDICT next-round ask #2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from henjou.bsdf.dispatch import bsdf_eval, bsdf_pdf, make_bsdf_sampler
from henjou.integrator.payload import Sky
from henjou.integrator.wavefront import wavefront_render
from henjou.runtime.camera import make_camera
from henjou.scene.scenedata import build_device_scene, build_frame_scene
from henjou.scene.testscenes import cornell_box_scene


def _setup():
    dev = build_device_scene(cornell_box_scene())
    frame = build_frame_scene(dev)
    sky = Sky(constant_color=jnp.zeros(3), intensity=jnp.asarray(0.0))
    cam = make_camera((0, 1.0, 3.5), (0, 0, -1), np.radians(45.0))
    bs = make_bsdf_sampler(None)
    beval = lambda hit, wo, wi: bsdf_eval(hit, wo, wi, None)
    return frame, sky, cam, bs, beval


@pytest.mark.slow
def test_flat_counts_match_uniform_and_two_pass_continuation():
    frame, sky, cam, bs, beval = _setup()
    w = h = 16
    spp = 8
    kw = dict(
        bsdf_eval=beval, bsdf_pdf=bsdf_pdf, integrator="mis", seed=3,
        lanes=1 << 10,
    )
    uni = wavefront_render(frame, sky, cam, w, h, spp, bs, **kw)
    counts = jnp.full((w * h,), spp, jnp.int32)
    ada = wavefront_render(
        frame, sky, cam, w, h, spp, bs, sample_counts=counts, **kw
    )
    np.testing.assert_allclose(
        np.asarray(ada.color), np.asarray(uni.color), rtol=1e-5, atol=1e-6
    )
    assert (np.asarray(ada.count) == spp).all()
    assert (np.asarray(uni.count) == spp).all()
    # second moment column: E[x^2] >= E[x]^2 with strict margin somewhere
    m2 = np.asarray(ada.m2)
    assert m2.sum() > 0

    # skewed allocation split into two passes with sample_base
    # continuation == the same allocation in one pass (same sample sets)
    counts2 = jnp.asarray(
        np.where(np.arange(w * h) % w < 8, 12, 4).astype(np.int32)
    )
    one = wavefront_render(
        frame, sky, cam, w, h, spp + 4, bs, sample_counts=counts2, **kw
    )
    assert (np.asarray(one.count) == np.asarray(counts2)).all()
    c_a = jnp.minimum(counts2, 6)
    c_b = counts2 - c_a
    p1 = wavefront_render(
        frame, sky, cam, w, h, spp + 4, bs, sample_counts=c_a, **kw
    )
    p2 = wavefront_render(
        frame, sky, cam, w, h, spp + 4, bs, sample_counts=c_b,
        sample_base=c_a, **kw
    )
    np.testing.assert_allclose(
        np.asarray(p1.color) + np.asarray(p2.color),
        np.asarray(one.color),
        rtol=1e-5, atol=1e-6,
    )


def test_allocation_is_deficit_based_and_bounded():
    """_adaptive_allocation: batch-proportional allocation let one
    firefly pixel reach 63x the mean count (measured round 4, RAW RMSE
    15% worse than uniform); the deficit form must (a) starve pixels
    already past their target, (b) keep sum <= budget, (c) favor
    high-variance pixels, (d) bound the implied TOTAL count ratio to
    the 8x weight clip."""
    from henjou.runtime.renderer import _adaptive_allocation

    rng = np.random.default_rng(0)
    npix, budget = 4096, 4096 * 16
    mu = np.full(npix, 0.5, np.float64)
    sig = np.full(npix, 0.1)
    sig[:64] = 5.0  # high-variance block
    cnt = np.full(npix, 32.0)
    cnt[64:128] = 4096.0  # already hugely over-sampled block
    csum = np.stack([mu * cnt] * 3, 1)
    m2 = (sig * sig + mu * mu) * cnt
    a = _adaptive_allocation(budget, csum, m2, cnt)
    assert a.sum() <= budget
    assert (a[64:128] == 0).all()  # (a) over-target pixels starved
    assert a[:64].mean() > 4 * a[128:].mean()  # (c)
    # (d) across repeated batches, totals stay within the clip band
    for _ in range(40):
        csum = np.stack([mu * cnt] * 3, 1)
        m2 = (sig * sig + mu * mu) * cnt
        a = _adaptive_allocation(budget, csum, m2, cnt)
        cnt = cnt + a
    # clip is [0.25, 8]x the PRE-clip weight mean; clipping shifts the
    # mean down, so the steady-state max/mean lands a bit above 8
    assert cnt.max() / cnt.mean() < 12.0, cnt.max() / cnt.mean()
    assert cnt[128:].min() / cnt.mean() > 0.2


def test_allocation_metric_std_ignores_pixel_mean():
    """metric="std" weights by absolute sigma (the optimal split for
    linear-HDR RMSE): two pixels with equal sigma but 100x different
    means must get equal targets, where "relstd" skews toward the dark
    one. Loader validation rejects unknown metric strings."""
    from henjou.runtime.renderer import _adaptive_allocation

    npix, budget = 256, 256 * 16
    mu = np.full(npix, 0.05)
    mu[:128] = 5.0  # bright half, same absolute noise
    sig = np.full(npix, 0.5)
    cnt = np.full(npix, 32.0)
    csum = np.stack([mu * cnt] * 3, 1)
    m2 = (sig * sig + mu * mu) * cnt
    a_abs = _adaptive_allocation(budget, csum, m2, cnt, metric="std")
    a_rel = _adaptive_allocation(budget, csum, m2, cnt, metric="relstd")
    assert abs(int(a_abs[:128].sum()) - int(a_abs[128:].sum())) <= npix
    assert a_rel[128:].sum() > 2 * a_rel[:128].sum()

    import json
    import os
    import tempfile

    from henjou.runtime.options import load_render_option

    base = os.path.join(os.path.dirname(__file__), "..", "scenes",
                        "rtcamp_option.json")
    with open(base) as f:
        cfg = json.load(f)
    cfg["Henjou"]["adaptive_metric"] = "nope"
    with tempfile.NamedTemporaryFile("w", suffix=".json") as f:
        json.dump(cfg, f)
        f.flush()
        with pytest.raises(ValueError, match="adaptive_metric"):
            load_render_option(f.name)


@pytest.mark.slow
def test_renderer_adaptive_loop_allocates_by_variance():
    from henjou.runtime.options import RenderOption
    from henjou.runtime.renderer import Renderer

    base = dict(
        image_width=32, image_height=32, max_spp=32, spp_batch=8,
        engine="wavefront", scene_sky_default=(0.0, 0.0, 0.0),
        camera_position=(0.0, 1.0, 3.5), camera_direction=(0.0, 0.0, -1.0),
    )
    r = Renderer(option=RenderOption(adaptive=True, **base))
    r.set_scene(cornell_box_scene()).build()
    a = r.render_frame(0)
    cnt = a["count"]
    # warm-up floor + non-flat allocation + near-budget mean
    assert cnt.min() >= 8
    assert cnt.max() > cnt.min()
    assert abs(float(cnt.mean()) - 32) < 8
    assert float(a["variance"].mean()) > 0

    r2 = Renderer(option=RenderOption(adaptive=False, **base))
    r2.set_scene(cornell_box_scene()).build()
    u = r2.render_frame(0)
    # same integral: images agree within Monte-Carlo noise at 32 spp
    assert abs(float(a["color"].mean()) - float(u["color"].mean())) < 0.01
    assert np.abs(a["color"] - u["color"]).mean() < 0.05
