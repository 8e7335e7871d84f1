#!/usr/bin/env python3
"""Smoke test of the renderer on an NVIDIA GPU, through its normal paths.

    python3 chip_smoke.py            # one GPU: phases 1-4
    python3 chip_smoke.py --four     # four GPUs: the sharded main path only

Phases (one process; every failure exits non-zero):
1. Device: JAX's first device must be a GPU; prints its kind, the device
   count and `nvidia-smi`'s name and power limit.
2. Intersector: on the contest scene's LBVH and 65,536 camera and
   65,536 incoherent rays, the route's intersector (the CUDA kernel)
   against the plain-XLA `accel/traverse.py`, both closest-hit and
   any-hit, and both against `accel/bruteforce.py` on 4,096 rays. Prints
   ms per 64k rays of each.
3. Known answer: the pinned 16x16 film (`tests/golden/`) rendered through
   the GPU route, per-pixel RMSE <= 5e-3.
4. Main path: `scenes/rtcamp_720_option.json` (1280x720, 2 frames, MIS,
   IBL, DenoiseTemporal) through `Renderer.initialize_and_render` with
   `max_spp` cut to `--spp`; PNGs written, films finite.

`--four` renders the main path at equal total spp with multichip "auto"
over four GPUs and with multichip "off" on GPU 0, and compares the films.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CONTEST_OPTION = os.path.join(HERE, "scenes", "rtcamp_720_option.json")
N_RAYS = 1 << 16
N_BRUTE = 4096


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def median_ms(fn, *args, reps=5):
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def phase_device(want_count):
    import jax

    devs = jax.devices()
    check(devs[0].platform == "gpu", f"no GPU: JAX's first device is {devs[0].platform!r}")
    check(len(devs) >= want_count, f"need {want_count} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    log(f"[device] kind={devs[0].device_kind} count={len(devs)}")
    for line in smi.stdout.strip().splitlines():
        log(f"[device] nvidia-smi: {line.strip()}")
    return devs


def load_contest(spp=None, out_dir=None, multichip=None):
    from henjou.runtime.renderer import Renderer

    r = Renderer()
    r.load_render_option(CONTEST_OPTION)
    over = {}
    if spp is not None:
        over["max_spp"] = spp
    if out_dir is not None:
        over["image_directory"] = out_dir
    if multichip is not None:
        over["multichip"] = multichip
    r.option = dataclasses.replace(r.option, **over)
    r._load_scene_from_option()
    return r


def compare_hits(name, ref, got):
    """Closest-hit results (t, prim, u, v, hit) against a reference."""
    import numpy as np

    t_r, p_r, u_r, v_r, h_r = (np.asarray(x) for x in ref)
    t_g, p_g, u_g, v_g, h_g = (np.asarray(x) for x in got)
    check((h_r == h_g).all(), f"{name}: hit masks differ on {int((h_r != h_g).sum())} rays")
    h = h_r
    rel = np.abs(t_g[h] - t_r[h]) / np.maximum(np.abs(t_r[h]), 1e-30)
    check((rel <= 1e-5).all(), f"{name}: t differs by {rel.max():.3e} relative")
    same = p_g[h] == p_r[h]
    tie = np.abs(t_g[h] - t_r[h]) <= 1e-5 * np.abs(t_r[h])
    check((same | tie).all(), f"{name}: prim differs on {int((~(same | tie)).sum())} non-tie rays")
    du = np.abs(u_g[h] - u_r[h])[same]
    dv = np.abs(v_g[h] - v_r[h])[same]
    check(du.size == 0 or (du.max() <= 1e-4 and dv.max() <= 1e-4),
          f"{name}: u/v differ by {max(du.max(), dv.max()):.3e}")
    log(f"[intersect] {name}: {int(h.sum())} hits agree, prim ties {int((~same).sum())}, "
        f"max |dt|/t {rel.max() if rel.size else 0.0:.2e}")


def phase_intersect():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from henjou.accel import cuda_traverse, traverse
    from henjou.accel.bruteforce import intersect_bruteforce, occluded_bruteforce
    from henjou.accel.lbvh import lbvh_depth
    from henjou.accel.route import route_for
    from henjou.math.constants import TMAX_RAY, ray_eps
    from henjou.runtime.camera import camera_rays_centers

    check(route_for().traversal == "cuda", f"GPU route traverses with {route_for().traversal!r}")
    r = load_contest()
    opt = r.option
    transforms, inv = r._frame_transforms(0.0)
    frame = r._frame_build(r.device_scene, transforms, inv)
    t0 = time.perf_counter()
    bvh = r._build_accel(frame)
    jax.block_until_ready(bvh)
    log(f"[intersect] contest LBVH: {bvh.num_tris} tris, jitted build incl. compile "
        f"{time.perf_counter() - t0:.2f} s")
    depth = lbvh_depth(bvh)
    log(f"[intersect] LBVH depth {depth} (kernel stack {cuda_traverse.STACK_SIZE}, "
        f"traverse.py stack {traverse.STACK_SIZE})")
    check(depth < traverse.STACK_SIZE and depth < cuda_traverse.STACK_SIZE,
          f"LBVH depth {depth} exceeds a traversal stack")

    rng = np.random.default_rng(20261016)
    cam = r._frame_camera(0.0)
    o_c, d_c = camera_rays_centers(cam, opt.image_width, opt.image_height)
    pick = jnp.asarray(rng.choice(o_c.shape[0], N_RAYS, replace=False))
    lo = np.asarray(bvh.aabb_min[0])
    hi = np.asarray(bvh.aabb_max[0])
    o_i = rng.uniform(lo, hi, (N_RAYS, 3)).astype(np.float32)
    d_i = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    d_i /= np.linalg.norm(d_i, axis=1, keepdims=True)
    eps = ray_eps(frame)
    tv = frame.tri_verts

    closest = {
        "cuda": jax.jit(lambda b, o, d: cuda_traverse.traverse_cuda(b, o, d, eps, TMAX_RAY)),
        "xla": jax.jit(lambda b, o, d: traverse.traverse_closest(b, o, d, eps, TMAX_RAY)),
    }
    anyhit = {
        "cuda": jax.jit(lambda b, o, d, tx: cuda_traverse.traverse_cuda(b, o, d, eps, tx, any_hit=True)),
        "xla": jax.jit(lambda b, o, d, tx: traverse.traverse_closest(b, o, d, eps, tx, any_hit=True)),
    }
    brute = jax.jit(lambda o, d: intersect_bruteforce(tv, o, d, eps, TMAX_RAY))
    brute_occ = jax.jit(lambda o, d, tx: occluded_bruteforce(tv, o, d, eps, tx))

    for kind, (o, d) in {"camera": (o_c[pick], d_c[pick]),
                         "incoherent": (jnp.asarray(o_i), jnp.asarray(d_i))}.items():
        res = {k: f(bvh, o, d) for k, f in closest.items()}
        compare_hits(f"{kind} closest cuda vs traverse.py", res["xla"], res["cuda"])
        # any-hit bounded at half and at 1.5x the closest distance
        t_ref = np.asarray(res["xla"][0])
        scale = np.where(np.arange(N_RAYS) % 2 == 0, 0.5, 1.5).astype(np.float32)
        tmax = jnp.asarray(np.where(np.isfinite(t_ref), t_ref * scale, TMAX_RAY).astype(np.float32))
        occ = {k: f(bvh, o, d, tmax) for k, f in anyhit.items()}
        check((np.asarray(occ["cuda"][4]) == np.asarray(occ["xla"][4])).all(),
              f"{kind} any-hit: cuda vs traverse.py masks differ")
        sub = slice(0, N_BRUTE)
        ref_b = brute(o[sub], d[sub])
        for k in ("cuda", "xla"):
            compare_hits(f"{kind} closest {k} vs bruteforce", ref_b, tuple(x[sub] for x in res[k]))
            occ_b = np.asarray(brute_occ(o[sub], d[sub], tmax[sub]))
            check((np.asarray(occ[k][4])[sub] == occ_b).all(),
                  f"{kind} any-hit {k} vs bruteforce: masks differ")
        log(f"[intersect] {kind}: any-hit masks agree ({int(np.asarray(occ['cuda'][4]).sum())} occluded)")
        for k in ("cuda", "xla"):
            ms_c = median_ms(closest[k], bvh, o, d)
            ms_a = median_ms(anyhit[k], bvh, o, d, tmax)
            log(f"[intersect] {kind} {k}: closest {ms_c:.3f} ms, any-hit {ms_a:.3f} ms "
                f"per {N_RAYS} rays")
        ms_b = median_ms(brute, o[sub], d[sub])
        log(f"[intersect] {kind} bruteforce: {ms_b:.3f} ms per {N_BRUTE} rays")


def phase_known_answer():
    from henjou.runtime.known_answer import (
        RMSE_TOL,
        known_answer_rmse,
        render_known_answer_film,
    )

    rmse = known_answer_rmse(render_known_answer_film())
    log(f"[known-answer] per-pixel RMSE {rmse:.3e} (tol {RMSE_TOL:.0e})")
    check(rmse <= RMSE_TOL, f"known-answer film RMSE {rmse:.3e} > {RMSE_TOL}")


def render_main(spp, out_dir, multichip=None):
    """Main path; returns [(frame, aovs, image)] and the written paths."""
    import numpy as np

    r = load_contest(spp=spp, out_dir=out_dir, multichip=multichip)
    frames = []
    finalize = r._finalize

    def capture(aovs, frame=None):
        img = finalize(aovs, frame=frame)
        frames.append((frame, aovs, np.asarray(img)))
        return img

    r._finalize = capture
    written = r.initialize_and_render()
    return frames, written


def phase_main(spp, out_dir):
    import jax
    import numpy as np

    from henjou.runtime.compile_cache import compile_cache_dir

    compile_s = []
    jax.monitoring.register_event_duration_secs_listener(
        lambda name, secs, **kw: compile_s.append(secs)
        if name == "/jax/core/compile/backend_compile_duration" else None
    )
    t0 = time.perf_counter()
    frames, written = render_main(spp, out_dir)
    wall = time.perf_counter() - t0
    check(len(written) == 2, f"expected 2 PNGs, got {written}")
    for p in written:
        check(os.path.getsize(p) > 0, f"missing PNG {p}")
    for frame, aovs, img in frames:
        check(np.isfinite(aovs["color"]).all() and np.isfinite(img).all(),
              f"frame {frame}: non-finite film")
        log(f"[main] frame {frame}: {aovs['spp_done']} spp, accel build {aovs['build_s']:.3f} s, "
            f"render {aovs['render_s']:.3f} s"
            + (" (includes the engine compile)" if frame == frames[0][0] else ""))
    log(f"[main] {len(written)} PNGs in {out_dir}; XLA compile {sum(compile_s):.1f} s "
        f"(cache {compile_cache_dir()}); whole run {wall:.1f} s")


def phase_four(spp, out_dir):
    import numpy as np

    sharded, _ = render_main(spp, os.path.join(out_dir, "auto"), multichip="auto")
    single, _ = render_main(spp, os.path.join(out_dir, "off"), multichip="off")
    for (f, a, _), (_, b, _) in zip(sharded, single):
        check(a["spp_done"] == b["spp_done"] == spp,
              f"frame {f}: spp {a['spp_done']} (4 GPUs) vs {b['spp_done']} (1 GPU), want {spp}")
        for key in ("color", "albedo", "normal"):
            np.testing.assert_allclose(a[key], b[key], rtol=3e-5, atol=1e-6,
                                       err_msg=f"frame {f} {key}: 4 GPUs vs 1")
        diff = np.abs(a["color"] - b["color"])
        log(f"[four] frame {f}: {spp} spp, films agree (max |diff| {diff.max():.3e}); "
            f"render {a['render_s']:.2f} s on 4 GPUs vs {b['render_s']:.2f} s on 1")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true", help="four-GPU sharded main path only")
    ap.add_argument("--spp", type=int, default=32, help="max_spp of the main path")
    ap.add_argument("--out", default=os.path.join(HERE, "build", "chip_smoke"))
    args = ap.parse_args()

    if not os.path.isdir(os.path.join(HERE, "henjou")):
        print("chip_smoke: the henjou package is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    os.chdir(HERE)  # scene configs name their assets relative to the root
    from henjou.runtime.compile_cache import enable_compile_cache

    enable_compile_cache()
    import logging

    logging.basicConfig(level=logging.INFO, format="[%(levelname).1s] %(name)s: %(message)s")
    try:
        devs = phase_device(4 if args.four else 1)
        if args.four:
            phase_four(args.spp, args.out)
        else:
            phase_intersect()
            phase_known_answer()
            phase_main(args.spp, args.out)
    except (SmokeFailure, AssertionError) as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
