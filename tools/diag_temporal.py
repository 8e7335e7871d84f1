"""Post-mortem for the temporal accumulation ledger (CPU only).

Loads build/quality/dbg_temporal_f1.npz (saved by `exp_quality.py temporal`)
plus the frame truths and answers, in order:
  1. is the REPROJECTION aligned? (warped prev albedo should match the
     current albedo BETTER than unwarped prev albedo — if not, px/py
     are wrong)
  2. what does the GATE accept? (distribution of the albedo/normal
     weight; mean effective history count)
  3. is the warped HISTORY radiance itself any good on accepted pixels?
     (RMSE of warped prev color vs the f1 truth, gated)
  4. where does the merged film lose vs the current raw? (per-pixel
     error delta, split by gate)
"""

import os
import sys

import numpy as np

import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def rmse(a, b):
    d = (np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2
    return float(np.sqrt(d.mean()))


def main():
    from henjou.post.denoise import _bilinear_sample

    d = np.load("build/quality/dbg_temporal_f1.npz")
    gt1 = np.load("build/quality/gt_rtcamp720gltf_f1.npz")["color"]
    px, py, valid = d["px"], d["py"], d["valid"]
    cur_alb, cur_nrm, cur = d["albedo"], d["normal"], d["color"]
    pa_raw, pn_raw, pc_raw = d["prev_albedo"], d["prev_normal"], d["prev_color"]

    print(f"valid fraction: {valid.mean():.4f}")
    dxy = np.stack([px - (np.arange(px.shape[1]) + 0.5)[None, :],
                    py - (np.arange(px.shape[0]) + 0.5)[:, None]])
    print(f"reproj offset px: mean |dx| {np.abs(dxy[0][valid]).mean():.2f} "
          f"|dy| {np.abs(dxy[1][valid]).mean():.2f} "
          f"p95 |dx| {np.percentile(np.abs(dxy[0][valid]), 95):.2f}")

    wa, inb = _bilinear_sample(jnp.asarray(pa_raw), jnp.asarray(px), jnp.asarray(py))
    wn, _ = _bilinear_sample(jnp.asarray(pn_raw), jnp.asarray(px), jnp.asarray(py))
    wc, _ = _bilinear_sample(jnp.asarray(pc_raw), jnp.asarray(px), jnp.asarray(py))
    wa, wn, wc, inb = map(np.asarray, (wa, wn, wc, inb))
    ok = (inb[..., 0] > 0) & valid

    # 1. alignment: warped vs unwarped albedo agreement
    print(f"albedo  |warped - cur| rmse: {rmse(wa[ok], cur_alb[ok]):.5f}   "
          f"UNwarped: {rmse(pa_raw[ok], cur_alb[ok]):.5f}")
    print(f"normal  |warped - cur| rmse: {rmse(wn[ok], cur_nrm[ok]):.5f}   "
          f"UNwarped: {rmse(pn_raw[ok], cur_nrm[ok]):.5f}")

    # 2. the gate
    da = ((cur_alb - wa) ** 2).sum(-1)
    dn = ((cur_nrm - wn) ** 2).sum(-1)
    gate = ok * np.exp(-da / 0.01) * np.exp(-dn / 0.04)
    print(f"gate: mean {gate.mean():.4f}  frac>0.5 {(gate > 0.5).mean():.4f} "
          f"frac>0.9 {(gate > 0.9).mean():.4f}")
    print(f"neff: mean {d['neff'].mean():.1f}  (48 = no history, 96 = full)")

    # 3. history radiance quality on accepted pixels
    m = gate > 0.5
    if m.any():
        print(f"on gate>0.5 pixels ({m.mean():.2%}):")
        print(f"  cur raw  vs truth: {rmse(cur[m], gt1[m]):.5f}")
        print(f"  warped hist vs truth: {rmse(wc[m], gt1[m]):.5f}")
        print(f"  50/50 blend vs truth: {rmse(0.5 * (cur[m] + wc[m]), gt1[m]):.5f}")
        print(f"  merged    vs truth: {rmse(d['merged'][m], gt1[m]):.5f}")

    # 4. where merged loses
    e_cur = ((cur - gt1) ** 2).sum(-1)
    e_mrg = ((d["merged"] - gt1) ** 2).sum(-1)
    worse = e_mrg > e_cur * 1.2
    print(f"pixels where merged >20% worse than raw: {worse.mean():.2%} "
          f"(their gate mean {gate[worse].mean() if worse.any() else 0:.3f})")
    print(f"overall: raw {rmse(cur, gt1):.5f}  merged {rmse(d['merged'], gt1):.5f}")


if __name__ == "__main__":
    main()
