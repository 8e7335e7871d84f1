"""Offline prototype: per-pixel shrinkage blend between the raw film and
the filtered output, to cut FILTER BIAS where the pixel is already
converged (round-4 quality sweep showed the denoiser's bias floor ~0.05
RMSE dominates once spp > ~100).

James-Stein-style weight per pixel: the filter changed the pixel by
d = filtered - raw. If |d|^2 is explained by the raw pixel's noise
variance, trust the filter; if |d|^2 >> noise var, the filter moved a
converged pixel (bias) — keep the raw value.

    w_filtered = var / (var + max(d^2 - var, 0) * k)

Runs on saved AOV dumps from tools/exp_quality.py `aovs` mode.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def main():
    import jax.numpy as jnp

    from henjou.post.denoise import denoise_atrous, denoise_atrous_var

    paths = sys.argv[1:] or [
        "build/quality/aovs_rtcamp720_cmj_120s.npz",
        "build/quality/aovs_rtcamp720_sobol_120s.npz",
        "build/quality/aovs_rtcamp720_cmj_ada_120s.npz",
    ]
    gt = np.load("build/quality/gt_rtcamp720.npz")["color"]
    for path in paths:
        d = np.load(path)
        color = jnp.asarray(d["color"])
        albedo = jnp.asarray(d["albedo"])
        normal = jnp.asarray(d["normal"])
        var = jnp.asarray(d["variance"])
        print(f"== {path}: raw {rmse(d['color'], gt):.5f}")
        base = denoise_atrous(color, albedo, normal)
        print(f"   atrous(fixed)        {rmse(base, gt):.5f}")
        for sl in (1.5, 2.0):
            filt = denoise_atrous_var(
                color, albedo, normal, var, sigma_lum=sl
            )
            print(f"   svgf sl={sl}          {rmse(filt, gt):.5f}")
            # shrinkage: var is variance-of-the-mean per pixel [H,W]
            v = jnp.maximum(var, 0.0)[..., None]
            d2 = jnp.mean((filt - color) ** 2, axis=-1, keepdims=True)
            for k in (0.25, 0.5, 1.0, 2.0):
                w = (v + 1e-12) / (v + jnp.maximum(d2 - v, 0.0) * k + 1e-12)
                out = filt * w + color * (1.0 - w)
                print(
                    f"   svgf sl={sl} shrink k={k:<4} {rmse(out, gt):.5f}"
                    f"  (mean w_filt {float(jnp.mean(w)):.3f})"
                )
        sys.stdout.flush()


if __name__ == "__main__":
    main()
