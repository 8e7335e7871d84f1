"""Renderer facade: load -> build -> frame loop -> export.

Rebuild of the reference `class Renderer` (include/renderer/renderer.h:138-1318)
with the lifecycle re-shaped for XLA:

- `build()` uploads the scene SoA once (cpySceneDataToDevice analogue,
  renderer.h:197-255).
- Per frame, animation transforms are evaluated on host and the scene is
  flattened to world space in one jitted gather+transform (the IAS-rebuild
  analogue, renderer.h:257-291).
- The frame is rendered in spp batches over pixel tiles: each jitted step
  runs `spp_batch` full paths for a tile of pixels and accumulates on
  device. Batching exists for compile-time, memory, the time-limit-aware
  scheduler, and checkpoint/resume (SURVEY.md §5) — the reference instead
  runs all max_spp inside one megakernel launch (renderer.h:1183,1241).
- Tone-mapped PNGs are written per frame with zero-padded names
  (renderer.h:1291-1301).
"""

from __future__ import annotations

import functools
import logging
import os
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from henjou.accel.lbvh import build_lbvh
from henjou.accel.route import BRUTE_FORCE_MAX_TRIS, make_intersectors, route_for
from henjou.integrator.pathtrace import pathtrace
from henjou.integrator.payload import Sky
from henjou.post.png import write_png
from henjou.post.srgb import float_to_srgb_u8
from henjou.runtime.camera import Camera, camera_rays, make_camera
from henjou.runtime.options import RenderMode, RenderOption, load_render_option
from henjou.sampling.cmj import make_cmj_state
from henjou.scene.scenedata import (
    DeviceScene,
    SceneData,
    build_device_scene,
    build_frame_scene,
    identity_transforms,
)

log = logging.getLogger("henjou")

# Lane tile: pixels per jitted step. 2^17 lanes keeps the intersector's
# [lanes, TRI_CHUNK] temporaries inside a few hundred MB of HBM.
DEFAULT_TILE = 1 << 17


@functools.lru_cache(maxsize=8)
def _swizzled_pixel_order(width: int, height: int, bw: int = 32, bh: int = 16):
    """Pixel indices reordered into bw x bh screen blocks, so neighbouring
    lanes of a masked-engine tile hold neighbouring pixels (coherent
    primary rays) instead of one scanline spanning the whole screen."""
    p = np.arange(width * height)
    px = p % width
    py = p // width
    blocks_x = (width + bw - 1) // bw
    key = (py // bh) * blocks_x + (px // bw)
    inner = (py % bh) * bw + (px % bw)
    return np.argsort(key * (bw * bh) + inner, kind="stable").astype(np.uint32)


def _pixel_chunks(n_pixels: int, chunk_max: int):
    """[(base, count)] contiguous pixel chunks, all but the last equal-
    sized, each <= chunk_max (film scatter fast-regime bound)."""
    if n_pixels <= chunk_max:
        return [(0, n_pixels)]
    n_chunks = -(-n_pixels // chunk_max)
    size = -(-n_pixels // n_chunks)
    return [
        (b, min(size, n_pixels - b)) for b in range(0, n_pixels, size)
    ]


def _adaptive_allocation(
    budget: int, color_sum: np.ndarray, m2: np.ndarray, cnt: np.ndarray,
    metric: str = "relstd",
) -> np.ndarray:
    """Per-pixel sample counts for the next batch: DEFICIT-based
    allocation toward target TOTAL counts n_p ~ w_p, where
    w_p = sigma_p / (mean_p + 0.05) (metric="relstd", the default —
    targets display-referred error) or w_p = sigma_p (metric="std" —
    n ~ sigma is the optimal fixed-budget split for ABSOLUTE per-pixel
    error, the quantity linear-HDR RMSE measures). Each batch fills max(target - current, 0),
    so a pixel that out-ran its target gets NOTHING until the rest
    catch up — allocating each batch proportional to the weights
    instead lets the max/mean count ratio run away (measured round 4:
    a 10,758-spp pixel at mean 170 spp, RAW RMSE 15% WORSE than
    uniform). Weights are clipped to [0.25, 8]x their mean, bounding
    the cumulative per-pixel count ratio to the same band: converged
    pixels keep sampling (live variance estimates), firefly pixels
    can't eat the budget. floor() keeps sum(a) <= budget — the
    engine's static sample list is budget-sized.

    The reference has no analogue (uniform max_spp, renderer.h:1183);
    allocation uses only PREVIOUS batches' samples, and every pixel is
    normalized by its own count, so each pixel's estimate stays the
    plain mean of i.i.d. samples."""
    n = np.maximum(cnt, 1.0)
    mu = (
        0.2126 * color_sum[:, 0]
        + 0.7152 * color_sum[:, 1]
        + 0.0722 * color_sum[:, 2]
    ) / n
    var = np.maximum(m2 / n - mu * mu, 0.0)
    w = np.sqrt(var)
    if metric == "relstd":
        w = w / (np.abs(mu) + 0.05)
    wm = max(float(w.mean()), 1e-12)
    w = np.clip(w, 0.25 * wm, 8.0 * wm)
    total = float(cnt.sum()) + float(budget)
    target = total * w / w.sum()
    need = np.maximum(target - cnt, 0.0)
    s = float(need.sum())
    if s <= 0.0:  # everyone at/over target: fall back to uniform
        return np.full(cnt.shape, budget // max(cnt.size, 1), np.int32)
    return np.floor(budget * need / s).astype(np.int32)


class Renderer:
    def __init__(
        self,
        option: Optional[RenderOption] = None,
        integrator: Optional[str] = None,
        bsdf_sample: Optional[Callable] = None,
        tile_size: int = DEFAULT_TILE,
    ):
        self.option = option or RenderOption()
        self.integrator = integrator or self.option.integrator
        self.bsdf_sample = bsdf_sample  # None -> full facade at build()
        self.tile_size = tile_size
        self.scene: Optional[SceneData] = None
        self.device_scene: Optional[DeviceScene] = None
        self.sky: Optional[Sky] = None
        self.lut = None
        self._step = None

    # ---------------- loading ----------------

    def load_render_option(self, path: str):
        self.option = load_render_option(path)
        return self

    def set_scene(self, scene: SceneData):
        self.scene = scene
        return self

    # ---------------- build ----------------

    def build(self):
        """Upload scene + compile-ready closures (reference build(),
        renderer.h:1015-1039)."""
        assert self.scene is not None, "set_scene or load a file first"
        # a (re)build invalidates everything keyed on the previous scene:
        # compiled steps close over sky/BSDF tables, the accel cache is
        # keyed only on transform bytes, and temporal history is per-scene
        self._wf_cache = {}
        self._accel_cache = None
        self._light_accel_cache = None
        self._temporal_history = None
        self._temporal_prev_frame = None
        self.device_scene = build_device_scene(self.scene)
        opt = self.option
        ibl_tex = None
        use_ibl = False
        if opt.use_ibl and opt.ibl_path and os.path.exists(opt.ibl_path):
            from henjou.texture.ibl import load_ibl

            ibl_tex = load_ibl(opt.ibl_path)
            use_ibl = True
        elif opt.use_ibl:
            log.warning("IBL requested but file missing: %s", opt.ibl_path)
        self.sky = Sky(
            constant_color=jnp.asarray(opt.scene_sky_default, jnp.float32),
            intensity=jnp.asarray(opt.ibl_intensity, jnp.float32),
            use_ibl=use_ibl,
            ibl_texture=ibl_tex,
        )
        # thin-film LUT (setLUT analogue, renderer.h:854-898): file if
        # configured, else the built-in analytic Airy LUT
        from henjou.texture.lut import default_lut, load_lut_png

        if opt.lut_path and os.path.exists(opt.lut_path):
            self.lut = load_lut_png(opt.lut_path)
        else:
            self.lut = default_lut()
        if self.bsdf_sample is None:
            from henjou.bsdf.dispatch import make_bsdf_sampler

            # static scene facts specialize the dispatch (lockstep lanes pay
            # for every compiled lobe, so drop the unused ones)
            mats = self.scene.materials
            has_specular = any(m["ideal_specular"] for m in mats)
            has_metal = any(
                m["metallic"] > 0.5 or m["metallic_tex"] >= 0 for m in mats
            )
            has_sheen = any(m["sheen"] > 0 for m in mats)
            has_clearcoat = any(m["clearcoat"] > 0 for m in mats)
            has_thinfilm = any(m["is_thinfilm"] for m in mats)
            # no thin-film material -> skip the per-bounce LUT gathers
            lut = self.lut if has_thinfilm else None
            self._bsdf_flags = dict(
                has_sheen=has_sheen, has_clearcoat=has_clearcoat
            )
            self._dispatch_lut = lut
            self.bsdf_sample = make_bsdf_sampler(
                lut, has_specular=has_specular, has_metal=has_metal,
                has_sheen=has_sheen, has_clearcoat=has_clearcoat,
            )
        from henjou.bsdf.dispatch import bsdf_eval, bsdf_pdf

        _lut = getattr(self, "_dispatch_lut", self.lut)
        _flags = getattr(self, "_bsdf_flags", {})
        self.bsdf_eval = lambda hit, wo, wi: bsdf_eval(hit, wo, wi, _lut, **_flags)
        self.bsdf_pdf = bsdf_pdf
        # trace-time sampler gate: only compile the Owen-Sobol branch into
        # the draw sites when this renderer's options actually select it
        # (sampling/cmj.py set_sobol_enabled); the default cmj path stays
        # free of the discarded ~100-op/lane Sobol pair per draw
        from henjou.sampling.cmj import set_sobol_enabled

        set_sobol_enabled(self.option.sampler == "sobol")
        self._step = self._make_step()
        self._frame_build = jax.jit(build_frame_scene)
        self._bvh_build = jax.jit(build_lbvh)
        return self

    # emissive-tri count above which the MIS branch's light query trades
    # the dense chunked Moller-Trumbore (cost O(R*L)) for an LBVH over the
    # emissive subset (sampling/light_sample.py LightAccel)
    LIGHT_ACCEL_THRESHOLD = 512
    # bigger frames render in contiguous pixel chunks of at most this
    # many pixels, which bounds the film operand of the per-iteration
    # scatter-add (ROADMAP S6: not yet re-derived on the GPU)
    FILM_CHUNK_PIXELS = 1 << 18

    def _build_accel(self, frame_scene):
        """The frame's acceleration structure: None (brute force) for tiny
        scenes, else the LBVH, built on the device by one jitted call."""
        if int(frame_scene.tri_verts.shape[0]) <= BRUTE_FORCE_MAX_TRIS:
            return None
        return self._bvh_build(frame_scene.tri_verts)

    @staticmethod
    def _intersectors(accel):
        """(intersect_fn, occluded_fn) for an accel from `_build_accel`:
        None selects brute force; an LBVH is traced by the backend's
        route (accel/route.py)."""
        if accel is None:
            return None, None
        return make_intersectors(accel)

    def _make_step(self):
        bsdf_sample = self.bsdf_sample
        bsdf_eval = getattr(self, "bsdf_eval", None)
        bsdf_pdf = getattr(self, "bsdf_pdf", None)
        integrator = self.integrator

        @functools.partial(jax.jit, static_argnames=("spp_count", "width", "height"))
        def step(
            frame_scene,
            accel,
            sky,
            cam: Camera,
            pixel_idx,
            spp_start,
            seed,
            spp_count: int,
            width: int,
            height: int,
        ):
            n = pixel_idx.shape[0]
            zero = jnp.zeros((n, 3), jnp.float32)

            intersect_fn, occluded_fn = Renderer._intersectors(accel)

            def body(i, acc):
                c, a, nm = acc
                state = make_cmj_state(
                    (spp_start + i).astype(jnp.uint32),
                    pixel_idx.astype(jnp.uint32),
                    seed,
                )
                o, d, state = camera_rays(cam, width, height, pixel_idx, state)
                if integrator == "pathtrace":
                    res = pathtrace(
                        frame_scene, sky, o, d, state, bsdf_sample,
                        intersect_fn=intersect_fn,
                    )
                elif integrator == "nee":
                    from henjou.integrator.nee import nee

                    res = nee(
                        frame_scene, sky, o, d, state, bsdf_sample, bsdf_eval,
                        intersect_fn=intersect_fn, occluded_fn=occluded_fn,
                    )
                elif integrator == "mis":
                    from henjou.integrator.mis import mis

                    res = mis(
                        frame_scene, sky, o, d, state,
                        bsdf_sample, bsdf_eval, bsdf_pdf,
                        intersect_fn=intersect_fn, occluded_fn=occluded_fn,
                    )
                else:
                    raise ValueError(f"unknown integrator {integrator}")
                return (c + res.lte, a + res.aov_albedo, nm + res.aov_normal)

            return jax.lax.fori_loop(0, spp_count, body, (zero, zero, zero))

        return step

    # ---------------- per-frame ----------------

    def _frame_transforms(self, time_s: float):
        """Animation -> per-instance transforms (updateIASMatrix analogue,
        renderer.h:257-291). Identity until the animation engine milestone."""
        from henjou.math.affine import invert_affine

        num_inst = len(self.scene.instances)
        xf = identity_transforms(num_inst)
        anims = self.scene.animations
        for i, inst in enumerate(self.scene.instances):
            if 0 <= inst.animation_id < len(anims):
                xf[i] = anims[inst.animation_id].get_affine(time_s)
        inv = np.stack([invert_affine(m) for m in xf])
        return jnp.asarray(xf), jnp.asarray(inv)

    def _frame_camera(self, time_s: float) -> Camera:
        opt = self.option
        anims = self.scene.animations if self.scene else []
        cam_id = self.scene.camera_animation_id if self.scene else -1
        if opt.allow_camera_animation and 0 <= cam_id < len(anims):
            # reference: renderer.h:1154-1163 — position through the full TRS
            # affine, direction/up through rotation only
            from henjou.math.affine import apply_affine_point, apply_affine_vector

            anim = anims[cam_id]
            affine_pos = anim.get_affine(time_s)
            affine_dir = anim.get_rotation_affine(time_s)
            pos = apply_affine_point(affine_pos, opt.camera_position)
            d = apply_affine_vector(affine_dir, opt.camera_direction)
            up = apply_affine_vector(affine_dir, (0.0, 1.0, 0.0))
            d = d / np.linalg.norm(d)
            right = np.cross(d, up)
            right = right / np.linalg.norm(right)
            return make_camera(pos, d, self._fov(), up=up, right=right)
        return make_camera(opt.camera_position, opt.camera_direction, self._fov())

    def _fov(self) -> float:
        if self.scene is not None and self.scene.camera_fov_from_file:
            return self.scene.camera_fov_from_file
        return self.option.camera_fov

    def _frame_seed(self, frame: int) -> int:
        """Per-frame sampler seed. sampler="sobol" sets the tag bit that
        routes every draw through the padded Owen-Sobol sequence
        (sampling/cmj.py SOBOL_SEED_FLAG); "cmj" masks it off so the
        bit-exact reference CMJ path is unconditional regardless of the
        user's seed value."""
        from henjou.sampling.cmj import SOBOL_SEED_FLAG

        s = (int(self.option.seed) + int(frame)) & 0xFFFFFFFF
        if self.option.sampler == "sobol":
            return s | SOBOL_SEED_FLAG
        return s & 0x7FFFFFFF

    def render_frame(
        self,
        frame: int,
        deadline: Optional[float] = None,
        checkpoint_path: Optional[str] = None,
    ) -> dict:
        """Render one frame; returns dict of [H,W,3] numpy AOVs
        (color/albedo/normal) plus 'spp_done', 'render_s' and 'build_s'.

        With `checkpoint_path`, accumulation state is snapshotted after
        every spp batch and resumed on restart — the progressive
        checkpoint/resume the reference lacks (SURVEY.md §5: each frame is
        one all-spp megakernel launch there)."""
        opt = self.option
        width, height = opt.image_width, opt.image_height
        if opt.render_mode == RenderMode.DENOISE_UPSCALE2X:
            width, height = width // 2, height // 2  # renderer.h:1096-1099
        n = width * height

        t_build0 = time.monotonic()
        time_s = frame / float(opt.fps)
        transforms, inv_transforms = self._frame_transforms(time_s)
        frame_scene = self._frame_build(self.device_scene, transforms, inv_transforms)
        cam = self._frame_camera(time_s)

        # Acceleration structure per frame (the reference's per-frame IAS
        # rebuild analogue, renderer.h:257-291): reused while transforms
        # are unchanged, else the LBVH is rebuilt on the device.
        accel_key = np.asarray(transforms).tobytes()
        cache = getattr(self, "_accel_cache", None)
        if cache and cache[0] == accel_key:
            accel = cache[1]
        else:
            accel = self._build_accel(frame_scene)
            self._accel_cache = (accel_key, accel)
        jax.block_until_ready(accel if accel is not None else frame_scene.tri_verts)
        build_ms = (time.monotonic() - t_build0) * 1e3

        color = np.zeros((n, 3), np.float32)
        albedo = np.zeros((n, 3), np.float32)
        normal = np.zeros((n, 3), np.float32)
        m2 = np.zeros((n,), np.float32)
        cnt = np.zeros((n,), np.float32)

        spp_done = 0
        if checkpoint_path and os.path.exists(checkpoint_path):
            ck = np.load(checkpoint_path)
            if int(ck["frame"]) == frame and ck["color"].shape == color.shape:
                color, albedo, normal = ck["color"], ck["albedo"], ck["normal"]
                spp_done = int(ck["spp_done"])
                if "m2" in ck and ck["m2"].shape == m2.shape:
                    m2, cnt = ck["m2"], ck["cnt"]
                else:
                    # pre-adaptive checkpoint: counts were uniform
                    cnt = np.full((n,), spp_done, np.float32)
                log.info("resumed frame %d at %d spp from %s", frame, spp_done, checkpoint_path)

        engine = self.option.engine
        if engine == "auto":
            engine = route_for().engine
        if (
            engine == "masked"
            and self.integrator == "mis"
            and self.option.mis_mode == "single"
        ):
            # the masked depth-loop engine always renders the reference
            # two-sample form — say so, or cross-backend image compares
            # (CPU auto->masked vs GPU auto->wavefront) surprise people
            log.info(
                "engine resolved to masked: MIS renders the two-sample "
                "(ref) estimator; mis_mode='single' applies to the "
                "wavefront engine only"
            )
        if engine == "wavefront":
            if build_ms > 1000.0:
                log.info(
                    "frame %d setup: flatten+accel %.1fs",
                    frame, build_ms / 1e3,
                )
            out = self._render_frame_wavefront(
                frame_scene, accel, cam, width, height, frame,
                deadline=deadline, checkpoint_path=checkpoint_path,
                resume=(color, albedo, normal, m2, cnt, spp_done),
            )
            out["build_s"] = build_ms / 1e3
            return out

        batch = max(1, opt.spp_batch)
        tile = self.tile_size
        pix_order = _swizzled_pixel_order(width, height)
        t0 = time.monotonic()
        # predictive deadline: the masked film normalizes by a single
        # uniform spp_done, so batches are indivisible — instead of
        # overshooting by up to a whole batch, stop BEFORE a batch whose
        # predicted cost (EMA of measured per-spp time) would not fit.
        # The estimate persists across frames (self) so later frames can
        # size their FIRST batch to a tight deadline instead of always
        # completing a full batch.
        est_spp_s = getattr(self, "_est_spp_s", None)
        while spp_done < opt.max_spp:
            cur = min(batch, opt.max_spp - spp_done)
            if (
                deadline is not None
                and spp_done == 0
                and est_spp_s is not None
            ):
                left = deadline - (time.monotonic() - t0)
                fit = max(1, int(left / max(est_spp_s, 1e-9)))
                if fit < cur:
                    # downsize only to an already-compiled spp variant
                    # (spp_count is a static jit arg; see the wavefront
                    # path's note on cold-compile cost)
                    compiled = [
                        s for s in getattr(self, "_spp_sizes_masked", ())
                        if s <= fit
                    ]
                    if compiled:
                        cur = max(compiled)
            if (
                deadline is not None
                and spp_done > 0
                and est_spp_s is not None
                and time.monotonic() - t0 + est_spp_s * cur > deadline
            ):
                log.warning(
                    "frame %d: deadline hit at %d/%d spp (next batch "
                    "would not fit)", frame, spp_done, opt.max_spp,
                )
                break
            t_batch = time.monotonic()
            for start in range(0, n, tile):
                stop = min(start + tile, n)
                pix_np = pix_order[start:stop]
                pix = jnp.asarray(pix_np)
                c, a, nm = self._step(
                    frame_scene,
                    accel,
                    self.sky,
                    cam,
                    pix,
                    jnp.uint32(spp_done),
                    jnp.uint32(self._frame_seed(frame)),
                    spp_count=cur,
                    width=width,
                    height=height,
                )
                color[pix_np] += np.asarray(c)
                albedo[pix_np] += np.asarray(a)
                normal[pix_np] += np.asarray(nm)
            per = (time.monotonic() - t_batch) / cur
            est_spp_s = (
                per if est_spp_s is None else 0.5 * est_spp_s + 0.5 * per
            )
            self._est_spp_s = est_spp_s
            self._spp_sizes_masked = set(
                getattr(self, "_spp_sizes_masked", ())
            ) | {cur}
            spp_done += cur
            if checkpoint_path:
                np.savez(
                    checkpoint_path + ".tmp.npz",
                    frame=frame,
                    spp_done=spp_done,
                    color=color,
                    albedo=albedo,
                    normal=normal,
                )
                os.replace(checkpoint_path + ".tmp.npz", checkpoint_path)
            # deadline-aware spp scheduler (reference keeps the guard
            # commented out, renderer.h:1248-1254; here it is live)
            if deadline is not None and time.monotonic() - t0 > deadline:
                log.warning(
                    "frame %d: deadline hit at %d/%d spp", frame, spp_done, opt.max_spp
                )
                break

        render_s = time.monotonic() - t0
        rays_lower_bound = n * spp_done  # >= 1 trace per path
        log.info(
            "frame %d timing: accel build %.1fms, render %.2fs (%d spp, >=%.1f Mrays/s)",
            frame,
            build_ms,
            render_s,
            spp_done,
            rays_lower_bound / max(render_s, 1e-9) / 1e6,
        )

        inv = 1.0 / max(spp_done, 1)
        out = {
            "color": (color * inv).reshape(height, width, 3),
            "albedo": (albedo * inv).reshape(height, width, 3),
            "normal": (normal * inv).reshape(height, width, 3),
            "spp_done": spp_done,
            "render_s": render_s,
            "build_s": build_ms / 1e3,
        }
        return out

    def _render_frame_wavefront(
        self, frame_scene, accel, cam, width, height, frame, deadline=None,
        checkpoint_path=None, resume=None,
    ) -> dict:
        """Persistent-lane wavefront execution (integrator/wavefront.py):
        lanes refill with fresh (pixel, spp) samples the moment a path
        terminates, so occupancy stays ~100% instead of decaying with
        depth as in the masked loop. Covers all three integrators."""
        from henjou.integrator.wavefront import wavefront_render

        opt = self.option
        bsdf_sample = self.bsdf_sample
        bsdf_eval = getattr(self, "bsdf_eval", None)
        bsdf_pdf = getattr(self, "bsdf_pdf", None)
        integrator = self.integrator
        sky = self.sky
        # refilling pool width: 64k lanes, fewer for frames that small
        # (ROADMAP S6: not yet re-derived on the GPU)
        lanes = min(
            1 << 16, max(1 << 12, 1 << (width * height - 1).bit_length())
        )

        # one-sample MIS (options.mis_mode="single", the default): the
        # path continuation doubles as the MIS branch, so no per-bounce
        # light query or branch occlusion trace exists at all
        mis_single = integrator == "mis" and opt.mis_mode != "ref"

        # mesh-light-heavy scenes (L > LIGHT_ACCEL_THRESHOLD emissive
        # tris) under the reference MIS estimator: trace the branch's
        # light query through an LBVH over the emissive SUBSET instead of
        # the dense O(R*L) Moller-Trumbore. The LightAccel is a pytree
        # passed as a jit ARG, so animated frames refresh it (rebuilt with
        # the main accel cache) without retracing the engine.
        light_accel = None
        n_lights = int(self.device_scene.num_lights)
        if (
            integrator == "mis"
            and not mis_single
            and n_lights > self.LIGHT_ACCEL_THRESHOLD
        ):
            from henjou.sampling.light_sample import build_light_accel

            la_cache = self._light_accel_cache
            la_key = self._accel_cache[0]
            if la_cache is not None and la_cache[0] == la_key:
                light_accel = la_cache[1]
            else:
                light_accel = jax.jit(build_light_accel)(
                    frame_scene.tri_verts, self.device_scene.light_prim_ids
                )
                self._light_accel_cache = (la_key, light_accel)
                log.info("light LBVH: %d emissive tris", n_lights)

        n = width * height
        # Pixel-chunked film (FILM_CHUNK_PIXELS). pixel_base rides as a
        # traced arg — one compile per chunk SIZE, not per chunk.
        chunks = _pixel_chunks(n, self.FILM_CHUNK_PIXELS)

        adaptive = bool(opt.adaptive)
        # firefly clamp: auto = on (64.0) for the Denoise render modes
        # only — parity-sensitive Default/Debug runs see unclamped
        # estimates (options.firefly_clamp)
        clamp = opt.firefly_clamp
        if clamp < 0.0:
            clamp = (
                64.0
                if opt.render_mode in (
                    RenderMode.DENOISE,
                    RenderMode.DENOISE_UPSCALE2X,
                    RenderMode.DENOISE_TEMPORAL,
                )
                else 0.0
            )

        # production multi-device (SURVEY.md §2.5 / §7 M8): when more than
        # one device is visible and multichip != off, every chunk step
        # spp-shards over ALL devices — device k renders sample indices
        # [spp_done + k*cur, spp_done + (k+1)*cur) of each pixel and the
        # per-pixel film SUMS are psum-reduced (the counter-based samplers
        # make index shifting exact sample partitioning). The reference's
        # one launch (renderer.h:1241) is single-GPU; this is its
        # multi-device replacement. A sharded step renders a multiple of
        # the device count, so max_spp must be one, or the frame would
        # overshoot it. Adaptive allocation stays single-device
        # (per-pixel count lists are host-planned per batch; it is
        # default-off).
        n_dev = len(jax.devices())
        shard_devs = 1
        if opt.multichip == "auto" and n_dev > 1:
            if adaptive or opt.max_spp % n_dev:
                if not getattr(self, "_warned_no_multichip", False):
                    log.info(
                        "multichip spp sharding off: %s",
                        "adaptive sampling plans per-batch counts on host"
                        if adaptive
                        else f"max_spp {opt.max_spp} is not a multiple of "
                        f"{n_dev} devices",
                    )
                    self._warned_no_multichip = True
            else:
                shard_devs = n_dev
        if shard_devs > 1 and not hasattr(self, "_mesh"):
            from henjou.runtime.sharding import make_mesh

            self._mesh = make_mesh()
            log.info(
                "multichip: spp sharding over %d devices (film psum)",
                shard_devs,
            )

        wf_key = (
            width, height, integrator, lanes, mis_single, adaptive, clamp,
            opt.light_ris, shard_devs,
        )
        cache = self._wf_cache
        if cache.get("key") != wf_key:
            def wf_body(
                frame_scene, accel, light_accel, cam, spp_offset, seed,
                pixel_base, sample_counts, sample_base,
                spp: int, pixel_count: int,
            ):
                ifn, ofn = Renderer._intersectors(accel)
                lfn = None
                if light_accel is not None:
                    from henjou.sampling.light_sample import (
                        make_light_intersector,
                    )

                    lfn = make_light_intersector(light_accel)
                return wavefront_render(
                    frame_scene, sky, cam, width, height, spp,
                    bsdf_sample, bsdf_eval=bsdf_eval, bsdf_pdf=bsdf_pdf,
                    integrator=integrator, seed=seed, lanes=lanes,
                    intersect_fn=ifn, occluded_fn=ofn,
                    spp_offset=spp_offset,
                    light_isect_fn=lfn, mis_single=mis_single,
                    pixel_base=pixel_base, pixel_count=pixel_count,
                    sample_counts=sample_counts,
                    sample_base=sample_base,
                    firefly_clamp=clamp,
                    light_ris=opt.light_ris,
                )

            if shard_devs > 1:
                from jax.sharding import PartitionSpec as P

                mesh = self._mesh

                @functools.partial(
                    jax.jit, static_argnames=("spp", "pixel_count")
                )
                def wf_args(
                    frame_scene, accel, light_accel, cam, spp_offsets,
                    seed, pixel_base, sample_counts, sample_base,
                    spp: int, pixel_count: int,
                ):
                    # per-device spp offsets are the ONLY sharded operand;
                    # the film pytree (per-pixel SUMS + trace count — all
                    # associative) is psum-reduced. check_vma off for the
                    # FFI call inside (see runtime/sharding.py
                    # wavefront_sharded_step)
                    @functools.partial(
                        jax.shard_map,
                        mesh=mesh,
                        in_specs=(P("d"),),
                        out_specs=P(),
                        check_vma=False,
                    )
                    def body(offs):
                        film = wf_body(
                            frame_scene, accel, light_accel, cam,
                            offs[0], seed, pixel_base, sample_counts,
                            sample_base, spp=spp,
                            pixel_count=pixel_count,
                        )
                        return jax.tree.map(
                            lambda x: jax.lax.psum(x, "d"), film
                        )

                    return body(spp_offsets)
            else:
                wf_args = jax.jit(
                    wf_body, static_argnames=("spp", "pixel_count")
                )

            cache = {"key": wf_key, "fn": wf_args}
            self._wf_cache = cache

        def wf_step(spp_offset, spp: int, base: int, count: int,
                    counts=None, cbase=None):
            if shard_devs > 1:
                spp_offset = jnp.uint32(spp_offset) + jnp.uint32(
                    spp
                ) * jnp.arange(shard_devs, dtype=jnp.uint32)
            return cache["fn"](
                frame_scene, accel, light_accel, cam, spp_offset,
                jnp.uint32(self._frame_seed(frame)), jnp.uint32(base),
                counts, cbase, spp=spp, pixel_count=count,
            )

        if resume is not None:
            color, albedo, normal, m2, cnt, spp_done = resume
        else:
            color = np.zeros((n, 3), np.float32)
            albedo = np.zeros((n, 3), np.float32)
            normal = np.zeros((n, 3), np.float32)
            m2 = np.zeros((n,), np.float32)
            cnt = np.zeros((n,), np.float32)
            spp_done = 0
        traces = 0.0
        batch = max(1, opt.spp_batch)
        t0 = time.monotonic()
        # Chunk-granular predictive deadline: a full spp batch at 1080p is
        # ~8 pixel chunks x seconds each, so a batch-level check can
        # overshoot the contest budget by a whole batch. Instead, before
        # each chunk, predict its cost from
        # an EMA of measured per-spp chunk time and stop when it would not
        # fit. Partial batches are unbiased: per-pixel `cnt` normalizes
        # every pixel by its own sample count. The FIRST batch always
        # completes so no pixel is left at zero samples.
        # The estimate persists across frames (self) so later frames can
        # size their indivisible FIRST batch down to fit a tight
        # deadline (frame 0's finalize overhead can leave frame 1 with
        # seconds, not minutes).
        est_spp_chunk = getattr(self, "_est_spp_chunk", None)
        stop = False
        while spp_done < opt.max_spp and not stop:
            # `cur` is the PER-DEVICE spp of this batch; one sharded step
            # advances the global budget by cur * shard_devs
            cur = min(batch, max(1, -(-(opt.max_spp - spp_done) // shard_devs)))
            if (
                deadline is not None
                and spp_done == 0
                and est_spp_chunk is not None
            ):
                left = deadline - (time.monotonic() - t0)
                fit = max(
                    1,
                    int(left / max(est_spp_chunk * len(chunks), 1e-9))
                    // shard_devs,
                )
                if fit < cur:
                    # only downsize to an spp the engine has ALREADY
                    # compiled this process: spp is a static jit arg, and
                    # compiling a fresh variant can cost more wall time
                    # than running the compiled batch size
                    compiled = [
                        s for s in getattr(self, "_spp_sizes", ())
                        if s <= fit
                    ]
                    if compiled:
                        cur = max(compiled)
            chunks_done = 0
            for base, count in chunks:
                if (
                    deadline is not None
                    and spp_done > 0
                    and est_spp_chunk is not None
                    and time.monotonic() - t0
                    + est_spp_chunk * cur * shard_devs
                    > deadline
                ):
                    stop = True
                    break
                t_chunk = time.monotonic()
                sl = slice(base, base + count)
                counts = cbase = None
                if adaptive:
                    if spp_done > 0:
                        a = _adaptive_allocation(
                            count * cur, color[sl], m2[sl], cnt[sl],
                            metric=opt.adaptive_metric,
                        )
                    else:
                        # uniform warm-up batch (variance not yet known)
                        a = np.full((count,), cur, np.int32)
                    counts = jnp.asarray(a)
                    cbase = jnp.asarray(cnt[sl].astype(np.int32))
                film = wf_step(
                    jnp.uint32(spp_done), cur, base, count, counts, cbase
                )
                color[sl] += np.asarray(film.color)
                albedo[sl] += np.asarray(film.albedo)
                normal[sl] += np.asarray(film.normal)
                m2[sl] += np.asarray(film.m2)
                cnt[sl] += np.asarray(film.count)
                traces += float(film.n_traces)
                chunks_done += 1
                # per GLOBAL spp (sharded steps buy shard_devs x spp/wall)
                per = (time.monotonic() - t_chunk) / (cur * shard_devs)
                # fast decay: the first sample includes jit compile
                est_spp_chunk = (
                    per if est_spp_chunk is None
                    else 0.5 * est_spp_chunk + 0.5 * per
                )
                self._est_spp_chunk = est_spp_chunk
                self._spp_sizes = set(
                    getattr(self, "_spp_sizes", ())
                ) | {cur}
            if stop:
                log.warning(
                    "frame %d: deadline hit at %d/%d spp (+%d/%d chunks of "
                    "the next batch)",
                    frame, spp_done, opt.max_spp, chunks_done, len(chunks),
                )
                break
            spp_done += cur * shard_devs
            if checkpoint_path:
                np.savez(
                    checkpoint_path + ".tmp.npz",
                    frame=frame, spp_done=spp_done,
                    color=color, albedo=albedo, normal=normal,
                    m2=m2, cnt=cnt,
                )
                os.replace(checkpoint_path + ".tmp.npz", checkpoint_path)
            if deadline is not None and time.monotonic() - t0 > deadline:
                log.warning(
                    "frame %d: deadline hit at %d/%d spp",
                    frame, spp_done, opt.max_spp,
                )
                break
        render_s = time.monotonic() - t0
        log.info(
            "frame %d wavefront[%s%s%s]: %.2fs (%d spp budget, %.1f Mtraces, "
            "%.1f Mrays/s)",
            frame, opt.mis_mode if integrator == "mis" else integrator,
            "+adaptive" if adaptive else "",
            f" x{shard_devs}chips" if shard_devs > 1 else "",
            render_s, spp_done, traces / 1e6,
            traces / max(render_s, 1e-9) / 1e6,
        )
        # per-pixel normalization: with adaptive allocation each pixel
        # divides by ITS OWN sample count (unbiased); uniform renders
        # have cnt == spp_done everywhere
        inv = (1.0 / np.maximum(cnt, 1.0))[:, None].astype(np.float32)
        mu = color * inv
        lum = (
            0.2126 * mu[:, 0] + 0.7152 * mu[:, 1] + 0.0722 * mu[:, 2]
        )
        # variance OF THE MEAN (feeds the variance-guided denoiser)
        var_mean = np.maximum(
            m2 * inv[:, 0] - lum * lum, 0.0
        ) * inv[:, 0]
        return {
            "color": mu.reshape(height, width, 3),
            "albedo": (albedo * inv).reshape(height, width, 3),
            "normal": (normal * inv).reshape(height, width, 3),
            "variance": var_mean.reshape(height, width),
            "count": cnt.reshape(height, width),
            "spp_done": spp_done,
            "render_s": render_s,
            "n_traces": traces,
        }

    def render_debug(self, frame: int) -> dict:
        """Debug render mode (render_option.h:42): first-hit
        position/basecolor/normal/texcoord AOV images, one sample, no
        bounces."""
        opt = self.option
        width, height = opt.image_width, opt.image_height
        time_s = frame / float(opt.fps)
        transforms, inv_transforms = self._frame_transforms(time_s)
        frame_scene = self._frame_build(self.device_scene, transforms, inv_transforms)
        cam = self._frame_camera(time_s)

        from henjou.integrator.payload import closest_hit
        from henjou.sampling.cmj import make_cmj_state

        @jax.jit
        def dbg(frame_scene, cam):
            pix = jnp.arange(width * height, dtype=jnp.uint32)
            st = make_cmj_state(jnp.zeros_like(pix), pix, opt.seed)
            o, d, st = camera_rays(cam, width, height, pix, st)
            hit = closest_hit(frame_scene, self.sky, o, d)
            return hit.position, hit.basecolor, hit.normal, hit.texcoord

        pos, base, nrm, tc = dbg(frame_scene, cam)
        return {
            "position": np.asarray(pos).reshape(height, width, 3),
            "basecolor": np.asarray(base).reshape(height, width, 3),
            "normal": np.asarray(nrm).reshape(height, width, 3),
            "texcoord": np.asarray(tc).reshape(height, width, 2),
        }

    # ---------------- full run ----------------

    def initialize_and_render(self, option_path: Optional[str] = None) -> list:
        """The one true entry point (reference: renderer.h:1053-1317).
        Returns the list of written PNG paths."""
        overall_t0 = time.monotonic()
        if option_path:
            self.load_render_option(option_path)
            self._load_scene_from_option()
        if self.device_scene is None:
            self.build()
        opt = self.option
        budget_s = opt.time_limit * 60.0

        # use_date: date-stamp the output names. (In the reference the
        # flag's `data` string is computed but dead — renderer.h:1085-1087
        # never reaches the filename at :1301; we implement the evident
        # intent so runs don't overwrite each other.)
        stamp = time.strftime("%Y%m%d-%H%M%S") + "_" if opt.use_date else ""

        written = []
        self._prewarm_finalize()
        # measured non-render overhead (scene flatten + accel refresh +
        # denoise/finalize + PNG write) of the previous frame, reserved
        # off every later frame's deadline so the WHOLE animation lands
        # inside budget_s (a 300 s contest run once overshot its budget
        # because finalize time was never charged to the schedule)
        overhead_est = 0.0
        for frame in range(opt.start_frame, opt.end_frame):
            t0 = time.monotonic()
            if opt.render_mode == RenderMode.DEBUG:
                # Debug mode: dump the four first-hit AOV images
                # (render_option.h:42)
                dbg = self.render_debug(frame)
                for key in ("position", "basecolor", "normal", "texcoord"):
                    img = dbg[key]
                    if img.shape[-1] == 2:
                        img = np.concatenate([img, np.zeros_like(img[..., :1])], -1)
                    u8 = np.asarray(float_to_srgb_u8(jnp.asarray(np.abs(img))))
                    name = f"{stamp}{opt.image_name}_{key}_{frame:03d}.png"
                    path = os.path.join(opt.image_directory, name)
                    write_png(path, u8)
                    written.append(path)
                continue
            remaining = budget_s - (t0 - overall_t0)
            # animation-wide budget (renderer.h:1073,1309: time_limit*60 s
            # for the WHOLE run): split what's left evenly over the frames
            # still to render, else frame 0 eats the entire budget and
            # every later frame's minimum spp batch overshoots it
            frames_left = max(opt.end_frame - frame, 1)
            out_dir = os.path.join(
                opt.image_directory, os.path.dirname(opt.image_name)
            )
            base = os.path.basename(opt.image_name)
            os.makedirs(out_dir or ".", exist_ok=True)
            ckpt = os.path.join(out_dir, f".{base}_{frame:03d}.ckpt.npz")
            deadline = max(
                (remaining - overhead_est * frames_left) / frames_left,
                1.0,
            )
            if frame == opt.start_frame and budget_s < float("inf"):
                # the first frame's finalize overhead (denoiser compile,
                # accel build, PNG encode) is unknown and large on cold
                # caches: under-allocate its render — unspent time rolls forward
                # to later frames, an overshoot cannot be clawed back
                deadline *= 0.6
            aovs = self.render_frame(
                frame,
                deadline=deadline,
                checkpoint_path=ckpt,
            )
            if os.path.exists(ckpt):
                os.remove(ckpt)  # frame complete
            t_fin = time.monotonic()
            img = self._finalize(aovs, frame=frame)
            fin_s = time.monotonic() - t_fin
            if fin_s > 1.0:
                log.info("frame %d finalize: %.1fs", frame, fin_s)
            u8 = np.asarray(float_to_srgb_u8(jnp.asarray(img)))
            name = f"{stamp}{opt.image_name}_{frame:03d}.png"  # renderer.h:1291-1301
            path = os.path.join(opt.image_directory, name)
            write_png(path, u8)
            written.append(path)
            frame_total = time.monotonic() - t0
            overhead = frame_total - float(aovs.get("render_s", 0.0))
            # latest measurement wins: frame 0's overhead includes the
            # one-time denoiser compile, so it over-reserves for frame 1
            # (conservative — undershooting the budget beats a contest DQ);
            # frames >=2 see the steady per-frame overhead
            overhead_est = overhead
            log.info(
                "frame %d: %d spp in %.2fs (render %.2fs, overhead %.2fs)"
                " -> %s",
                frame,
                aovs["spp_done"],
                frame_total,
                float(aovs.get("render_s", 0.0)),
                overhead,
                path,
            )
        log.info(
            "animation done: %.2fs / budget %.2fs",
            time.monotonic() - overall_t0,
            budget_s,
        )
        return written

    def _finalize(self, aovs: dict, frame: int = None) -> np.ndarray:
        """Default mode = denoiser passthrough (blendFactor 1.0,
        denoiser.h:94-97): the raw color AOV; Denoise/UpScale2X/Temporal
        map to the denoiser kinds (denoiser.h:35-40)."""
        mode = self.option.render_mode
        if mode == RenderMode.DEBUG:
            return aovs["albedo"]
        if mode == RenderMode.DENOISE_TEMPORAL:
            from henjou.post.denoise import denoise_temporal

            color = jnp.asarray(aovs["color"])
            albedo = jnp.asarray(aovs["albedo"])
            normal = jnp.asarray(aovs["normal"])
            prev = getattr(self, "_temporal_history", None)
            # history is only valid for the immediately preceding frame
            # of the same sequence (denoiser.h temporal model needs
            # consecutive frames); anything else restarts spatially
            prev_frame = getattr(self, "_temporal_prev_frame", None)
            # an unknown frame index can't prove adjacency: restart
            # spatially rather than blend history from an unrelated render
            sequential = (
                frame is not None
                and prev_frame is not None
                and frame == prev_frame + 1
            )
            cam = None
            pos = hitm = None
            if frame is not None and self.device_scene is not None:
                # depth probe for motion-compensated history (also run on
                # the first frame so its camera is banked for frame+1)
                t_probe0 = time.monotonic()
                time_s = frame / float(self.option.fps)
                transforms, inv_t = self._frame_transforms(time_s)
                frame_scene = self._frame_build(
                    self.device_scene, transforms, inv_t
                )
                cam = self._frame_camera(time_s)
                cache = getattr(self, "_accel_cache", None)
                accel = cache[1] if cache else None
                pos, hitm = _temporal_depth_probe(
                    frame_scene,
                    self.sky,
                    cam,
                    accel,
                    color.shape[1],
                    color.shape[0],
                )
                jax.block_until_ready(pos)
                # one pixel-center closest-hit pass; kept separate
                # from the engine's packed film (logged below)
                log.info(
                    "temporal depth probe: %.3fs (%dx%d)",
                    time.monotonic() - t_probe0,
                    color.shape[1], color.shape[0],
                )
            prev_cam = getattr(self, "_temporal_prev_cam", None)
            # PRE-FILTER accumulation state: (raw mean, var-of-mean,
            # effective count, albedo, normal) — only the wavefront
            # engine exports variance/count
            raw_hist = getattr(self, "_temporal_raw", None)
            have_film = (
                aovs.get("variance") is not None
                and aovs.get("count") is not None
            )
            variance = cnt = None
            if have_film:
                variance = jnp.asarray(aovs["variance"])
                cnt = jnp.asarray(aovs["count"]).astype(color.dtype)
            new_raw = None
            if prev is None or prev[0].shape != color.shape or not sequential:
                out = self._spatial_denoise(aovs)
            elif cam is not None and prev_cam is not None and pos is not None:
                from henjou.runtime.camera import project_to_pixel

                h, w = color.shape[0], color.shape[1]
                px, py, infront = project_to_pixel(
                    prev_cam, pos.reshape(-1, 3), w, h
                )
                px = px.reshape(h, w)
                py = py.reshape(h, w)
                valid = infront.reshape(h, w) & hitm
                if (
                    have_film
                    and raw_hist is not None
                    and raw_hist[0].shape == color.shape
                ):
                    # SVGF-style temporal integration: merge warped raw
                    # history into the film BEFORE the spatial filter —
                    # effective spp nearly doubles on agreeing pixels,
                    # so the variance-guided filter starts from a lower
                    # noise floor (post-filter output blending measured
                    # a wash: BASELINE.md round-5 temporal ledger)
                    from henjou.post.denoise import temporal_accumulate

                    merged, var_m, n_eff = temporal_accumulate(
                        color, variance, cnt, albedo, normal,
                        raw_hist[0], raw_hist[1], raw_hist[2],
                        raw_hist[3], raw_hist[4],
                        px, py, valid,
                    )
                    out = self._spatial_denoise(
                        dict(aovs, color=merged, variance=var_m)
                    )
                    new_raw = (merged, var_m, n_eff, albedo, normal)
                    # reprojection fields + consumed history for offline
                    # diagnostics (tools/exp_quality.py temporal)
                    self._temporal_dbg = (px, py, valid, raw_hist)
                else:
                    from henjou.post.denoise import (
                        denoise_temporal_reprojected,
                    )

                    out = denoise_temporal_reprojected(
                        color, albedo, normal, *prev, px, py, valid,
                        spatial=self._spatial_denoise(aovs),
                    )
            else:
                out = denoise_temporal(
                    color, albedo, normal, *prev,
                    spatial=self._spatial_denoise(aovs),
                )
            if new_raw is None and have_film:
                new_raw = (color, variance, cnt, albedo, normal)
            self._temporal_raw = new_raw
            self._temporal_history = (out, albedo, normal)
            self._temporal_prev_frame = frame
            self._temporal_prev_cam = cam
            return np.asarray(out)
        if mode in (RenderMode.DENOISE, RenderMode.DENOISE_UPSCALE2X):
            out = self._spatial_denoise(aovs)
            if mode == RenderMode.DENOISE_UPSCALE2X:
                guides = self._full_res_guides(frame)
                if guides is not None:
                    from henjou.post.denoise import upscale2x_guided

                    out = upscale2x_guided(
                        out,
                        jnp.asarray(aovs["albedo"]),
                        jnp.asarray(aovs["normal"]),
                        *guides,
                    )
                else:
                    from henjou.post.denoise import upscale2x

                    out = upscale2x(jnp.asarray(out))
            return np.asarray(out)
        return aovs["color"]

    def _full_res_guides(self, frame: int = None):
        """Full-resolution albedo/normal guides for the guided 2x
        upsampler (one pixel-center primary-hit pass at OUTPUT res —
        the UPSCALE2X guide layers the reference feeds its trained
        upscaler, denoiser.h:83-101). Returns (albedo[H,W,3],
        normal[H,W,3]) or None, in which case the caller falls back to
        plain bilinear. Cost: one deterministic closest-hit pass, same
        budget class as the temporal depth probe."""
        if self.device_scene is None:
            return None
        t0 = time.monotonic()
        time_s = (frame or 0) / float(self.option.fps)
        transforms, inv_t = self._frame_transforms(time_s)
        frame_scene = self._frame_build(
            self.device_scene, transforms, inv_t
        )
        cam = self._frame_camera(time_s)
        cache = getattr(self, "_accel_cache", None)
        accel = cache[1] if cache else None
        alb, nrm = _guide_probe(
            frame_scene,
            self.sky,
            cam,
            accel,
            self.option.image_width,
            self.option.image_height,
        )
        jax.block_until_ready(alb)
        log.info(
            "upscale guide probe: %.3fs (%dx%d)",
            time.monotonic() - t0,
            self.option.image_width,
            self.option.image_height,
        )
        return alb, nrm

    def _prewarm_finalize(self):
        """Compile the finalize pipeline (SVGF à-trous, + 2x upscale for
        that mode) on zero AOVs at the real output shapes in a daemon
        thread, so the compile overlaps frame 0's render instead of
        running serially after it (on a cold cache most of frame 0's
        finalize overhead is this compile). XLA compilation is host-side and
        jax's jit cache de-duplicates concurrent compiles of the same
        computation, so the real _finalize call either finds the cache
        warm or blocks on the in-flight compile."""
        opt = self.option
        if opt.render_mode not in (
            RenderMode.DENOISE,
            RenderMode.DENOISE_UPSCALE2X,
            RenderMode.DENOISE_TEMPORAL,
        ):
            return
        w, h = opt.image_width, opt.image_height
        if opt.render_mode == RenderMode.DENOISE_UPSCALE2X:
            w, h = w // 2, h // 2
        engine = opt.engine
        if engine == "auto":
            engine = route_for().engine

        def _prewarm():
            try:
                z3 = jnp.zeros((h, w, 3), jnp.float32)
                aovs = {"color": z3, "albedo": z3, "normal": z3}
                if engine == "wavefront":
                    # wavefront films carry the variance AOV -> SVGF path
                    aovs["variance"] = jnp.zeros((h, w), jnp.float32)
                out = Renderer._spatial_denoise(aovs)
                if opt.render_mode == RenderMode.DENOISE_UPSCALE2X:
                    from henjou.post.denoise import upscale2x

                    out = upscale2x(out)
                jax.block_until_ready(out)
                log.info("finalize prewarm done (%dx%d)", w, h)
            except Exception:  # pragma: no cover - prewarm is best-effort
                log.exception("finalize prewarm failed (harmless)")

        import threading

        threading.Thread(
            target=_prewarm, name="finalize-prewarm", daemon=True
        ).start()

    @staticmethod
    def _spatial_denoise(aovs: dict):
        """Spatial reconstruction pass: VARIANCE-GUIDED (SVGF-weighted)
        à-trous when the engine's variance AOV is present (wavefront
        renders), fixed-sigma à-trous otherwise (masked engine)."""
        color = jnp.asarray(aovs["color"])
        albedo = jnp.asarray(aovs["albedo"])
        normal = jnp.asarray(aovs["normal"])
        if aovs.get("variance") is not None:
            from henjou.post.denoise import denoise_atrous_var

            return denoise_atrous_var(
                color, albedo, normal, jnp.asarray(aovs["variance"])
            )
        from henjou.post.denoise import denoise_atrous

        return denoise_atrous(color, albedo, normal)

    def _load_scene_from_option(self):
        opt = self.option
        path = os.path.join(opt.gltf_path, opt.gltf_name)
        lower = path.lower()
        if lower.endswith((".gltf", ".glb")):
            from henjou.scene.gltf import load_gltf

            self.set_scene(load_gltf(path))
        elif lower.endswith(".obj"):
            from henjou.scene.obj import load_obj

            self.set_scene(load_obj(path))
        else:
            raise ValueError(f"unsupported scene file: {path}")
        self.build()


@functools.partial(jax.jit, static_argnames=("width", "height"))
def _guide_probe(frame_scene, sky, cam, accel, width, height):
    """Pixel-center first-hit (albedo[H,W,3], normal[H,W,3]) at FULL
    output resolution: the guide layers for the joint-bilateral 2x
    upsampler (upscale2x_guided; the reference feeds the same guides to
    its trained UPSCALE2X NN, denoiser.h:83-101). Same structure and
    budget class as _temporal_depth_probe — one deterministic
    closest-hit pass, and hit.basecolor/hit.normal carry exactly the
    semantics the wavefront engine writes into its first-bounce AOV
    columns (wavefront.py:332-333), so the half-res AOVs and these
    full-res guides live in the same domain."""
    from henjou.integrator.payload import closest_hit
    from henjou.runtime.camera import camera_rays_centers

    ifn, _ = Renderer._intersectors(accel)
    o, d = camera_rays_centers(cam, width, height)
    hit = closest_hit(frame_scene, sky, o, d, intersect_fn=ifn)
    return (
        hit.basecolor.reshape(height, width, 3),
        hit.normal.reshape(height, width, 3),
    )


@functools.partial(jax.jit, static_argnames=("width", "height"))
def _temporal_depth_probe(frame_scene, sky, cam, accel, width, height):
    """Pixel-center first-hit world positions for temporal reprojection:
    ([H,W,3] position, [H,W] hit mask). One deterministic closest-hit
    pass per frame (the flow-vector source the OptiX TEMPORAL denoiser
    takes as input, denoiser.h:35-40) — noise-free and negligible next
    to the frame's spp loop. `accel` rides as a pytree argument so
    animated frames reuse the compiled probe."""
    from henjou.integrator.payload import closest_hit
    from henjou.runtime.camera import camera_rays_centers

    ifn, _ = Renderer._intersectors(accel)
    o, d = camera_rays_centers(cam, width, height)
    hit = closest_hit(frame_scene, sky, o, d, intersect_fn=ifn)
    return (
        hit.position.reshape(height, width, 3),
        hit.is_hit.reshape(height, width),
    )
