"""Quality-per-second validation: adaptive sampling + variance-guided
denoise vs the uniform baseline, RMSE against a long-run ground truth
(round-3 VERDICT asks #2/#3 'done' criteria).

Modes (run on the GPU, rtcamp contest scene @ 1280x720):
  truth   render GT_SPP uniform spp, save raw mean -> build/quality/gt_rtcamp720.npz
  run     render both a uniform and an adaptive frame under BUDGET_S,
          then report RMSE vs the truth for: raw uniform, raw adaptive,
          fixed-sigma denoised, variance-guided denoised
  aovs    render ONE frame under BUDGET_S and save every AOV ->
          build/quality/aovs_rtcamp720_<tag>.npz (offline denoiser-tuning input)
  tune    offline: sweep denoiser params on a saved aovs file vs truth
          (no render; seconds per variant)
Usage:
  python tools/exp_quality.py truth [--spp 512]
  python tools/exp_quality.py run [--budget 300] [--sampler cmj|sobol]
  python tools/exp_quality.py aovs [--budget 120] [--sampler ...] [--adaptive]
  python tools/exp_quality.py tune [--aovs build/quality/aovs_rtcamp720_<tag>.npz]
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from henjou.runtime.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
os.makedirs("build/quality", exist_ok=True)  # outputs below, relative to the repo root

import numpy as np

GT_PATH = "build/quality/gt_rtcamp720.npz"
W, H = 1280, 720


def _renderer(
    adaptive: bool, max_spp: int, firefly_clamp: float = 0.0,
    sampler: str = "cmj", metric: str = "relstd", light_ris: int = 0,
):
    from henjou.runtime.options import RenderOption
    from henjou.runtime.renderer import Renderer
    from henjou.scene.testscenes import rtcamp_scene

    opt = RenderOption(
        image_width=W, image_height=H, max_spp=max_spp, spp_batch=16,
        engine="wavefront", adaptive=adaptive, firefly_clamp=firefly_clamp,
        sampler=sampler, adaptive_metric=metric, light_ris=light_ris,
        scene_sky_default=(0.35, 0.45, 0.62),
        camera_position=(0.0, 6.0, -16.5),
        camera_direction=(0.0, -0.28, 1.0),
        camera_fov=np.radians(40.0),
    )
    r = Renderer(option=opt)
    r.set_scene(rtcamp_scene())
    r.build()
    return r


def rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)))


def rmse_srgb(a, b):
    """Display-space RMSE (piecewise sRGB encode of the [0,1]-clipped
    linear image). The half-res/upscale and temporal ledgers MUST be
    scored here as well: in linear HDR the metric is dominated by
    sub-pixel clamped-16.0 highlights a half-res render cannot
    represent (a PERFECT half-res image bilinear-upsampled scores
    linear RMSE 0.39 vs the 720p truth — worse than a raw 32-spp
    full-res render), so linear RMSE cannot rank these modes."""

    def enc(x):
        x = np.clip(np.asarray(x), 0.0, 1.0)
        return np.where(
            x <= 0.0031308, 12.92 * x, 1.055 * x ** (1 / 2.4) - 0.055
        )

    return float(np.sqrt(np.mean((enc(a) - enc(b)) ** 2)))


def main():
    mode = sys.argv[1] if len(sys.argv) > 1 else "run"
    if mode == "truth":
        spp = 512
        if "--spp" in sys.argv:
            spp = int(sys.argv[sys.argv.index("--spp") + 1])
        r = _renderer(adaptive=True, max_spp=spp)
        t0 = time.monotonic()
        aovs = r.render_frame(0)
        np.savez_compressed(
            GT_PATH, color=aovs["color"].astype(np.float32), spp=spp
        )
        print(
            f"truth: {spp} spp budget in {time.monotonic() - t0:.0f}s -> "
            f"{GT_PATH}", flush=True,
        )
        return

    budget = 300.0
    if "--budget" in sys.argv:
        budget = float(sys.argv[sys.argv.index("--budget") + 1])
    sampler = "cmj"
    if "--sampler" in sys.argv:
        sampler = sys.argv[sys.argv.index("--sampler") + 1]
    metric = "relstd"
    if "--metric" in sys.argv:
        metric = sys.argv[sys.argv.index("--metric") + 1]

    if mode == "aovs":
        adaptive = "--adaptive" in sys.argv
        # --spp N: sample-matched dump (fixed total, no deadline) —
        # adaptive redistributes the SAME total across pixels, so
        # uniform-vs-adaptive comparisons are estimator-only
        fixed = 0
        if "--spp" in sys.argv:
            fixed = int(sys.argv[sys.argv.index("--spp") + 1])
        tag = f"{sampler}{'_ada' if adaptive else ''}" \
              f"{'_' + metric if metric != 'relstd' else ''}" \
              f"_{f'{fixed}spp' if fixed else f'{int(budget)}s'}"
        r = _renderer(adaptive=adaptive, max_spp=fixed or 100000,
                      firefly_clamp=64.0, sampler=sampler, metric=metric)
        t0 = time.monotonic()
        aovs = r.render_frame(0, deadline=None if fixed else budget)
        wall = time.monotonic() - t0
        out = f"build/quality/aovs_rtcamp720_{tag}.npz"
        np.savez_compressed(
            out,
            **{k: np.asarray(v) for k, v in aovs.items() if v is not None},
        )
        gt = np.load(GT_PATH)["color"]
        print(
            f"aovs[{tag}]: {aovs['spp_done']} spp in {wall:.1f}s, raw RMSE "
            f"{rmse(aovs['color'], gt):.5f} -> {out}", flush=True,
        )
        return

    if mode == "tune":
        _tune()
        return

    if mode == "temporal":
        _temporal(budget)
        return

    if mode == "upscale":
        _upscale(budget)
        return

    if mode == "ris":
        # RIS/WRS next-event light sampling: equal-BUDGET uniform renders
        # at m=0 (plain) vs m in {4, 8} candidates; the win must show in
        # RMSE-per-second (RIS costs dense VPU math per bounce, so fewer
        # spp land in the same wall time).
        import jax.numpy as jnp

        from henjou.post.denoise import denoise_atrous_var

        gt = np.load(GT_PATH)["color"]
        print(f"ris: budget {budget:.0f}s", flush=True)
        for m in (0, 4, 8):
            r = _renderer(adaptive=False, max_spp=100000,
                          firefly_clamp=64.0, light_ris=m)
            if m == 0:
                print(
                    f"  scene emissive prims: {r.device_scene.num_lights}",
                    flush=True,
                )
            t0 = time.monotonic()
            aovs = r.render_frame(0, deadline=budget)
            wall = time.monotonic() - t0
            raw = aovs["color"]
            demod = np.asarray(
                denoise_atrous_var(
                    jnp.asarray(raw), jnp.asarray(aovs["albedo"]),
                    jnp.asarray(aovs["normal"]),
                    jnp.asarray(aovs["variance"]), demodulate=True,
                )
            )
            print(
                f"  m={m}: {wall:6.1f}s  spp {aovs['spp_done']:4d}  "
                f"RMSE raw {rmse(raw, gt):.5f}  svgf+demod "
                f"{rmse(demod, gt):.5f}",
                flush=True,
            )
        return

    gt = np.load(GT_PATH)["color"]

    import jax.numpy as jnp

    from henjou.post.denoise import denoise_atrous, denoise_atrous_var

    results = {}
    # adapt75: adaptive at 0.75x the budget — proves the round-3 ask #2
    # criterion (match uniform's RMSE with >=25% fewer samples)
    print(f"run: budget {budget:.0f}s, sampler {sampler}", flush=True)
    for name, adaptive, share in (
        ("uniform", False, 1.0),
        ("adaptive", True, 1.0),
        ("adapt75", True, 0.75),
    ):
        r = _renderer(adaptive=adaptive, max_spp=100000, firefly_clamp=64.0,
                      sampler=sampler)
        t0 = time.monotonic()
        aovs = r.render_frame(0, deadline=budget * share)
        wall = time.monotonic() - t0
        raw = aovs["color"]
        fixed = np.asarray(
            denoise_atrous(
                jnp.asarray(raw), jnp.asarray(aovs["albedo"]),
                jnp.asarray(aovs["normal"]),
            )
        )
        guided = np.asarray(
            denoise_atrous_var(
                jnp.asarray(raw), jnp.asarray(aovs["albedo"]),
                jnp.asarray(aovs["normal"]),
                jnp.asarray(aovs["variance"]), demodulate=False,
            )
        )
        demod = np.asarray(
            denoise_atrous_var(
                jnp.asarray(raw), jnp.asarray(aovs["albedo"]),
                jnp.asarray(aovs["normal"]),
                jnp.asarray(aovs["variance"]), demodulate=True,
            )
        )
        results[name] = dict(
            spp=aovs["spp_done"], wall=wall,
            counts=(
                float(aovs["count"].min()), float(aovs["count"].mean()),
                float(aovs["count"].max()),
            ),
            raw=rmse(raw, gt), fixed=rmse(fixed, gt),
            guided=rmse(guided, gt), demod=rmse(demod, gt),
        )
        print(
            f"{name:9s} {wall:6.1f}s  spp-budget {aovs['spp_done']:4d} "
            f"counts(min/mean/max) {results[name]['counts']}  "
            f"RMSE raw {results[name]['raw']:.5f}  "
            f"atrous {results[name]['fixed']:.5f}  "
            f"svgf {results[name]['guided']:.5f}  "
            f"svgf+demod {results[name]['demod']:.5f}",
            flush=True,
        )
    u, a = results["uniform"], results["adaptive"]
    a75 = results["adapt75"]
    print(
        f"summary: adaptive raw RMSE {a['raw']:.5f} vs uniform "
        f"{u['raw']:.5f} ({(1 - a['raw'] / u['raw']) * 100:+.1f}%), "
        f"svgf vs atrous (adaptive) "
        f"{(1 - a['guided'] / a['fixed']) * 100:+.1f}%, "
        f"demod vs svgf (adaptive) "
        f"{(1 - a['demod'] / a['guided']) * 100:+.1f}%; "
        f"adaptive@75% raw {a75['raw']:.5f} "
        f"({'<=' if a75['raw'] <= u['raw'] else '>'} uniform@100%)",
        flush=True,
    )


def _temporal(budget: float):
    """DenoiseTemporal vs per-frame Denoise on the CONTEST animation
    (round-4 VERDICT #5): 2 frames of the shipped rtcamp gltf (orbiting
    camera, ~1.5 deg/frame at fps 24), equal per-frame budget. The
    question: does motion-compensated history reuse (depth-probe
    reprojection, post/denoise.py denoise_temporal_reprojected) beat an
    independent SVGF on frame 1 at the same wall-clock?

    Truths: build/quality/gt_rtcamp720gltf_f{0,1}.npz rendered here on first
    use (--truth-spp, default 512 spp budget per frame).
    Usage: python tools/exp_quality.py temporal [--budget 60]
           [--truth-spp 512]
    """
    from henjou.runtime.options import RenderMode, load_render_option
    from henjou.runtime.renderer import Renderer

    truth_spp = 512
    if "--truth-spp" in sys.argv:
        truth_spp = int(sys.argv[sys.argv.index("--truth-spp") + 1])
    # --spp N: SAMPLE-MATCHED arms (fixed spp, no deadline) — the
    # deadline scheduler hands out whole 16-spp chunks, so equal-budget
    # arms can differ by ~25% spp run-to-run, which swamps the
    # temporal-vs-spatial delta being measured
    fixed_spp = 0
    if "--spp" in sys.argv:
        fixed_spp = int(sys.argv[sys.argv.index("--spp") + 1])
    opt_path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "scenes", "rtcamp_720_option.json",
    )

    import dataclasses

    def _mk(mode: RenderMode, max_spp: int) -> Renderer:
        opt = dataclasses.replace(
            load_render_option(opt_path),
            render_mode=mode, max_spp=max_spp, firefly_clamp=64.0,
        )
        r = Renderer(option=opt)
        r._load_scene_from_option()
        return r

    gt = {}
    for f in (0, 1):
        path = f"build/quality/gt_rtcamp720gltf_f{f}.npz"
        if not os.path.exists(path):
            r = _mk(RenderMode.DEFAULT, truth_spp)
            t0 = time.monotonic()
            aovs = r.render_frame(f)
            np.savez_compressed(
                path, color=aovs["color"].astype(np.float32),
                spp=aovs["spp_done"],
            )
            print(
                f"truth f{f}: {aovs['spp_done']} spp in "
                f"{time.monotonic() - t0:.0f}s -> {path}", flush=True,
            )
        gt[f] = np.load(path)["color"]

    print(
        f"temporal: {f'{fixed_spp} spp (sample-matched)' if fixed_spp else f'budget {budget:.0f}s'}"
        f"/frame, contest gltf", flush=True,
    )
    for arm, mode in (
        ("spatial", RenderMode.DENOISE),
        ("temporal", RenderMode.DENOISE_TEMPORAL),
    ):
        r = _mk(mode, fixed_spp if fixed_spp else 100000)
        # warm the pipeline so frame 0's budget isn't all compile
        r.render_frame(0, deadline=0.5)
        for f in (0, 1):
            t0 = time.monotonic()
            aovs = r.render_frame(
                f, deadline=None if fixed_spp else budget
            )
            img = np.asarray(r._finalize(aovs, frame=f))
            wall = time.monotonic() - t0
            merged = ""
            raw_hist = getattr(r, "_temporal_raw", None)
            if arm == "temporal" and raw_hist is not None and f > 0:
                merged = (
                    f"  merged {rmse(np.asarray(raw_hist[0]), gt[f]):.5f}"
                    f"  neff {float(np.mean(np.asarray(raw_hist[2]))):.1f}"
                )
                dbg = getattr(r, "_temporal_dbg", None)
                if dbg is not None:
                    np.savez_compressed(
                        f"build/quality/dbg_temporal_f{f}.npz",
                        px=np.asarray(dbg[0]), py=np.asarray(dbg[1]),
                        valid=np.asarray(dbg[2]),
                        prev_color=np.asarray(dbg[3][0]),
                        prev_var=np.asarray(dbg[3][1]),
                        prev_count=np.asarray(dbg[3][2]),
                        prev_albedo=np.asarray(dbg[3][3]),
                        prev_normal=np.asarray(dbg[3][4]),
                        merged=np.asarray(raw_hist[0]),
                        neff=np.asarray(raw_hist[2]),
                        color=aovs["color"], albedo=aovs["albedo"],
                        normal=aovs["normal"],
                        variance=aovs["variance"], count=aovs["count"],
                    )
            print(
                f"  {arm:8s} f{f}: {wall:6.1f}s  spp {aovs['spp_done']:4d}"
                f"  raw {rmse(aovs['color'], gt[f]):.5f}"
                f"  out {rmse(img, gt[f]):.5f}"
                f"  srgb {rmse_srgb(img, gt[f]):.5f}{merged}", flush=True,
            )


def _upscale(budget: float):
    """DenoiseUpScale2X ledger (round-4 VERDICT #6 'done' criterion):
    at EQUAL wall-clock on the contest gltf, does half-res render +
    guided 2x upsample beat full-res render + SVGF? Arms:
      fullres   1280x720 render, SVGF
      up-guided  640x360 render (4x the spp), SVGF, joint-bilateral
                guided upsample (full-res albedo/normal probe)
      up-bilin  same film, plain bilinear upscale (the old path)
    Truth: the f0 gltf truth from the temporal mode.
    Usage: python tools/exp_quality.py upscale [--budget 60]
    """
    import dataclasses

    import jax.numpy as jnp

    from henjou.post.denoise import upscale2x
    from henjou.runtime.options import RenderMode, load_render_option
    from henjou.runtime.renderer import Renderer

    gt = np.load("build/quality/gt_rtcamp720gltf_f0.npz")["color"]
    opt_path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "scenes", "rtcamp_720_option.json",
    )

    def _mk(mode: RenderMode) -> Renderer:
        opt = dataclasses.replace(
            load_render_option(opt_path),
            render_mode=mode, max_spp=100000, firefly_clamp=64.0,
        )
        r = Renderer(option=opt)
        r._load_scene_from_option()
        return r

    print(f"upscale: budget {budget:.0f}s, contest gltf 720p", flush=True)
    r = _mk(RenderMode.DENOISE)
    r.render_frame(0, deadline=0.5)  # warm compile
    t0 = time.monotonic()
    aovs = r.render_frame(0, deadline=budget)
    img = np.asarray(r._finalize(aovs, frame=0))
    print(
        f"  fullres  : {time.monotonic() - t0:6.1f}s  spp "
        f"{aovs['spp_done']:4d}  raw {rmse(aovs['color'], gt):.5f}  "
        f"svgf {rmse(img, gt):.5f}  srgb {rmse_srgb(img, gt):.5f}",
        flush=True,
    )

    r = _mk(RenderMode.DENOISE_UPSCALE2X)
    r.render_frame(0, deadline=0.5)
    t0 = time.monotonic()
    aovs = r.render_frame(0, deadline=budget)
    img_g = np.asarray(r._finalize(aovs, frame=0))
    wall = time.monotonic() - t0
    spatial = r._spatial_denoise(aovs)
    img_b = np.asarray(upscale2x(jnp.asarray(spatial)))
    print(
        f"  up-guided: {wall:6.1f}s  spp {aovs['spp_done']:4d} "
        f"(@640x360)  out {rmse(img_g, gt):.5f}  "
        f"srgb {rmse_srgb(img_g, gt):.5f}", flush=True,
    )
    print(
        f"  up-bilin : same film               out {rmse(img_b, gt):.5f}  "
        f"srgb {rmse_srgb(img_b, gt):.5f}", flush=True,
    )
    # the resolution bound: a PERFECT half-res image, bilinear-upsampled
    gt_lo = gt.reshape(
        gt.shape[0] // 2, 2, gt.shape[1] // 2, 2, 3
    ).mean(axis=(1, 3))
    perf = np.asarray(upscale2x(jnp.asarray(gt_lo)))
    print(
        f"  bound    : perfect half-res + bilin   out {rmse(perf, gt):.5f}  "
        f"srgb {rmse_srgb(perf, gt):.5f}", flush=True,
    )


def _tune():
    """Offline denoiser-parameter sweep on a saved AOV dump (no
    render): the round-4 quality run measured variance-GUIDED à-trous
    LOSING to the fixed-sigma filter at contest scale (0.04745 vs
    0.04446 RMSE) — sweep sigma_lum / iterations / demodulation to find
    whether that's a tuning artifact or structural."""
    import jax.numpy as jnp

    from henjou.post.denoise import denoise_atrous, denoise_atrous_var

    path = "build/quality/aovs_rtcamp720_cmj_120s.npz"
    if "--aovs" in sys.argv:
        path = sys.argv[sys.argv.index("--aovs") + 1]
    d = np.load(path)
    gt = np.load(GT_PATH)["color"]
    color, albedo = jnp.asarray(d["color"]), jnp.asarray(d["albedo"])
    normal, var = jnp.asarray(d["normal"]), jnp.asarray(d["variance"])
    print(f"tune on {path}: raw RMSE {rmse(d['color'], gt):.5f}")
    base = np.asarray(denoise_atrous(color, albedo, normal))
    print(f"  atrous(fixed)                       {rmse(base, gt):.5f}")
    best = (None, 1e9)
    for it in (4, 5, 6):
        for sl in (0.5, 1.0, 1.5, 2.0, 3.0):
            for dm in (False, True):
                for pw in (False, True):
                    out = np.asarray(
                        denoise_atrous_var(
                            color, albedo, normal, var,
                            iterations=it, sigma_lum=sl, demodulate=dm,
                            pairwise=pw,
                        )
                    )
                    e = rmse(out, gt)
                    tag = (
                        f"svgf it={it} sigma_lum={sl:5.1f} "
                        f"demod={int(dm)} pair={int(pw)}"
                    )
                    print(f"  {tag}  {e:.5f}", flush=True)
                    if e < best[1]:
                        best = (tag, e)
    print(f"best: {best[0]} RMSE {best[1]:.5f} "
          f"(atrous fixed {rmse(base, gt):.5f})")


if __name__ == "__main__":
    main()
