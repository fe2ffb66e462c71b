"""Renderer facade: canary -> load -> build -> frame loop -> finalize ->
export.

Port of henjou_tpu/runtime/renderer.py: `build`, `frame_scene` (a
frame's geometry, built once per frame; its accel comes from
`runtime/scene_accel.py`), `render_frame` (one frame
loop for both engines: spp batches over pixel groups, the predictive
deadline, checkpoint/resume after every spp batch) with each engine's
step: `_make_wavefront_step` (contiguous pixel chunks through
`wavefront_render`) and `_make_masked_step` (the depth-loop engine:
131,072-pixel tiles in swizzled order over `_integrate`), `render_debug`,
`_finalize` (every render mode: the spatial SVGF denoiser, temporal
reprojection and accumulation, the guided 2x upscale) with its first-hit
probes, `initialize_and_render` (the hardware canary on CUDA, the time
budget and the PNG naming), and glTF and OBJ scenes. ``engine="auto"``
is the wavefront engine on every device (the JAX package picks the masked
engine on the CPU); ``engine="masked"`` renders the reference's
two-sample estimators. `SceneAccel` (`runtime/scene_accel.py`) picks
and caches each frame's accel, hands the engines their trace functions
and the two-sample MIS light query; the probes trace through the raw
binned intersector.

Under a profiler, spans (`utils/timer.py`) mark the frame loop's parts
(`frame.scene`, `frame.render`, `engine.step`, `frame.film_readback`,
`frame.checkpoint`, `frame.finalize` with its probe and filters,
`frame.output`) and the accel's host pack, plan and device refresh inside
the frame's scene (`accel.pack`, `accel.plan`, `accel.refresh`);
`initialize_and_render` moves each frame's spans and counters into its
`frame_stats` entry (keys `spans`, `counters`).

The denoiser runs on the renderer's device: the engine's numpy AOVs go up
once per frame and the temporal history stays there between frames. A
failing probe or canary raises; nothing falls back.

The opt-in options render as in the JAX package: ``sampler="sobol"``
(the seed's tag bit, carried by each renderer's CMJ states rather than a
process-wide gate), and on the wavefront engine ``light_ris`` (resampled
NEE lights), ``adaptive`` (a uniform warm-up batch, then deficit-based
per-pixel counts from `_adaptive_allocation`) and ``HENJOU_POOL_SORT=1``
(the raw binned kernels with the whole lane pool sorted after every
bounce). The masked engine ignores ``adaptive`` and ``light_ris``, as
the JAX package's does.

Multi-GPU is one process per GPU (`runtime/sharding.py`): with
``multichip="auto"`` and an initialised `torch.distributed` group of more
than one process, `render_frame` shards every batch's samples over the
group (process k takes sample indices spp_done + k*cur ..) and sums the
films with one all-reduce per pixel group; rank 0 decides every deadline
stop, and only rank 0 finalizes, writes PNGs and checkpoints. A frame
that is not sharded (adaptive allocation, as in the JAX package, or any
frame when ``multichip`` is not "auto") renders once, on rank 0: the
other processes skip it in `initialize_and_render`, and only rank 0 reads
or writes its checkpoint.
"""

from __future__ import annotations

import functools
import logging
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from henjou_torch.integrator.payload import Sky
from henjou_torch.post.png import write_png
from henjou_torch.post.srgb import float_to_srgb_u8
from henjou_torch.runtime.camera import Camera, make_camera
from henjou_torch.runtime import scene_accel, sharding
from henjou_torch.runtime.options import RenderMode, RenderOption, load_render_option
from henjou_torch.sampling.cmj import SOBOL_SEED_FLAG
from henjou_torch.scene.scenedata import (
    DeviceScene,
    SceneData,
    build_device_scene,
    build_frame_scene,
    identity_transforms,
)
from henjou_torch.utils import timer
from henjou_torch.utils.timer import span

log = logging.getLogger("henjou_torch")

# the Denoise render modes, in which the firefly clamp's auto mode is on
DENOISE_MODES = (RenderMode.DENOISE, RenderMode.DENOISE_UPSCALE2X,
                 RenderMode.DENOISE_TEMPORAL)


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and is not
    available (there is no silent fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available "
            "(pass device='cpu' to render on the CPU)"
        )
    return dev


def _pixel_chunks(n_pixels: int, chunk_max: int):
    """[(base, count)] contiguous pixel chunks, all but the last equal-
    sized, each <= chunk_max."""
    if n_pixels <= chunk_max:
        return [(0, n_pixels)]
    n_chunks = -(-n_pixels // chunk_max)
    size = -(-n_pixels // n_chunks)
    return [(b, min(size, n_pixels - b)) for b in range(0, n_pixels, size)]


@functools.lru_cache(maxsize=8)
def _swizzled_pixel_order(width: int, height: int, bw: int = 32, bh: int = 16) -> np.ndarray:
    """Pixel indices (i64) reordered into bw x bh screen blocks, so a tile
    of the masked engine is a set of compact image blocks (coherent first
    rays). Cached: do not write to the result."""
    p = np.arange(width * height)
    px = p % width
    py = p // width
    blocks_x = (width + bw - 1) // bw
    key = (py // bh) * blocks_x + (px // bw)
    inner = (py % bh) * bw + (px % bw)
    return np.argsort(key * (bw * bh) + inner, kind="stable").astype(np.int64)


def _adaptive_allocation(
    budget: int, color_sum: np.ndarray, m2: np.ndarray, cnt: np.ndarray,
    metric: str = "relstd",
) -> np.ndarray:
    """Per-pixel sample counts for the next batch (the JAX package's,
    copied): a deficit-based allocation toward total counts n_p ~ w_p,
    with w_p = sigma_p / (mean_p + 0.05) (metric "relstd", display-referred
    error) or w_p = sigma_p ("std", absolute error). Each batch fills
    max(target - current, 0), so a pixel past its target gets nothing
    until the rest catch up; weights are clipped to [0.25, 8]x their mean;
    floor() keeps the sum within `budget`. Only earlier batches' samples
    steer it, and every pixel divides by its own count, so each pixel's
    estimate stays a plain mean."""
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
    # bigger frames render in pixel chunks of at most this many pixels
    FILM_CHUNK_PIXELS = 1 << 18
    # pixels per tile of the masked engine (the JAX package's DEFAULT_TILE)
    MASKED_TILE = 1 << 17
    # the frame loop's per-pixel sums, as a checkpoint names them
    _CKPT_SUMS = ("color", "albedo", "normal", "m2", "cnt")
    # the JAX Renderer's name for SceneAccel's light threshold
    BINNED_LIGHT_THRESHOLD = scene_accel.BINNED_LIGHT_THRESHOLD

    def __init__(self, option: Optional[RenderOption] = None,
                 integrator: Optional[str] = None, device="cuda"):
        self.device = resolve_device(device)
        self.option = option or RenderOption()
        self.integrator = integrator or self.option.integrator
        self.scene: Optional[SceneData] = None
        self.device_scene: Optional[DeviceScene] = None
        self.sky: Optional[Sky] = None
        self.lut = None
        self.bsdf_sample: Optional[Callable] = None
        self.scene_accel: Optional[scene_accel.SceneAccel] = None
        # (frame, option, (FrameScene, accel, camera)) of the last
        # `frame_scene` call, for the finalize probes of the same frame
        self._frame_kept = None
        # the frame loop's seconds per pixel-spp, per engine
        self._est_px_spp: dict = {}
        # DenoiseTemporal state: the previous output with its guides, the
        # banked raw film (mean, variance, effective count, guides), the
        # frame it belongs to and that frame's camera
        self._temporal_history = None
        self._temporal_raw = None
        self._temporal_prev_frame = None
        self._temporal_prev_cam = None
        # per-phase seconds of scene setup, and one entry per rendered frame
        self.setup_stats: dict = {}
        self.frame_stats: list = []
        self._warned_adaptive_shard = False

    # ---------------- loading ----------------

    def load_render_option(self, path: str):
        self.option = load_render_option(path)
        self.integrator = self.option.integrator
        return self

    def set_scene(self, scene: SceneData):
        self.scene = scene
        return self

    # ---------------- build ----------------

    def build(self):
        """Upload the scene and make the BSDF closures."""
        assert self.scene is not None, "set_scene or load a file first"
        self._frame_kept = None
        t0 = time.monotonic()
        self.device_scene = build_device_scene(self.scene, self.device)
        self.scene_accel = scene_accel.SceneAccel(self.device_scene, self.device)
        opt = self.option
        ibl_tex = None
        use_ibl = False
        if opt.use_ibl and opt.ibl_path and os.path.exists(opt.ibl_path):
            from henjou_torch.texture.ibl import load_ibl

            ibl_tex = load_ibl(opt.ibl_path, self.device)
            use_ibl = True
        elif opt.use_ibl:
            log.warning("IBL requested but file missing: %s", opt.ibl_path)
        self.sky = Sky(
            constant_color=torch.tensor(opt.scene_sky_default, dtype=torch.float32,
                                        device=self.device),
            intensity=torch.tensor(opt.ibl_intensity, dtype=torch.float32,
                                   device=self.device),
            use_ibl=use_ibl,
            ibl_texture=ibl_tex,
        )
        from henjou_torch.texture.lut import default_lut, load_lut_png

        if opt.lut_path and os.path.exists(opt.lut_path):
            self.lut = load_lut_png(opt.lut_path, self.device)
        else:
            self.lut = default_lut(self.device)

        from henjou_torch.bsdf.dispatch import bsdf_eval, bsdf_pdf, make_bsdf_sampler

        # scene facts specialise the dispatch: lobes no material uses are
        # skipped, and without a thin-film material the LUT is not read
        mats = self.scene.materials
        has_specular = any(m["ideal_specular"] for m in mats)
        has_metal = any(m["metallic"] > 0.5 or m["metallic_tex"] >= 0 for m in mats)
        flags = dict(
            has_sheen=any(m["sheen"] > 0 for m in mats),
            has_clearcoat=any(m["clearcoat"] > 0 for m in mats),
        )
        lut = self.lut if any(m["is_thinfilm"] for m in mats) else None
        self.bsdf_sample = make_bsdf_sampler(
            lut, has_specular=has_specular, has_metal=has_metal, **flags
        )
        self.bsdf_eval = lambda hit, wo, wi: bsdf_eval(hit, wo, wi, lut, **flags)
        self.bsdf_pdf = bsdf_pdf
        self.setup_stats["device_scene_s"] = time.monotonic() - t0
        return self

    # ---------------- per-frame ----------------

    def _frame_transforms(self, time_s: float):
        """Animation -> per-instance transforms and their inverses."""
        from henjou_torch.math.affine import invert_affine

        num_inst = len(self.scene.instances)
        xf = identity_transforms(num_inst)
        anims = self.scene.animations
        for i, inst in enumerate(self.scene.instances):
            if 0 <= inst.animation_id < len(anims):
                xf[i] = anims[inst.animation_id].get_affine(time_s)
        inv = np.stack([invert_affine(m) for m in xf])
        return xf, inv

    def _frame_camera(self, time_s: float) -> Camera:
        opt = self.option
        anims = self.scene.animations if self.scene else []
        cam_id = self.scene.camera_animation_id if self.scene else -1
        if opt.allow_camera_animation and 0 <= cam_id < len(anims):
            # position through the full TRS affine, direction/up through
            # the rotation only
            from henjou_torch.math.affine import apply_affine_point, apply_affine_vector

            anim = anims[cam_id]
            affine_pos = anim.get_affine(time_s)
            affine_dir = anim.get_rotation_affine(time_s)
            pos = apply_affine_point(affine_pos, opt.camera_position)
            d = apply_affine_vector(affine_dir, opt.camera_direction)
            up = apply_affine_vector(affine_dir, (0.0, 1.0, 0.0))
            d = d / np.linalg.norm(d)
            right = np.cross(d, up)
            right = right / np.linalg.norm(right)
            return make_camera(pos, d, self._fov(), self.device, up=up, right=right)
        return make_camera(opt.camera_position, opt.camera_direction, self._fov(),
                           self.device)

    def _fov(self) -> float:
        if self.scene is not None and self.scene.camera_fov_from_file:
            return self.scene.camera_fov_from_file
        return self.option.camera_fov

    def _frame_seed(self, frame: int) -> int:
        """Per-frame sampler seed: sampler="sobol" sets the tag bit that
        routes every draw through the Sobol sequence (SOBOL_SEED_FLAG);
        "cmj" clears it, whatever the user's seed."""
        s = (int(self.option.seed) + int(frame)) & 0xFFFFFFFF
        if self.option.sampler == "sobol":
            return s | SOBOL_SEED_FLAG
        return s & 0x7FFFFFFF

    def _sobol(self) -> bool:
        return self.option.sampler == "sobol"

    def frame_scene(self, frame: int):
        """(FrameScene, accel, camera) of `frame`, the accel from
        `SceneAccel.pack`. The result is kept until the next call for
        another frame or option, so the finalize probes reuse the triple
        that `render_frame` built."""
        kept = self._frame_kept
        if kept is None or kept[0] != frame or kept[1] is not self.option:
            fs, xf, cam = self._frame_geometry(frame)
            self._frame_kept = (frame, self.option, (fs, self.scene_accel.pack(fs, xf), cam))
        return self._frame_kept[2]

    def _frame_geometry(self, frame: int):
        """(FrameScene, instance transforms, camera) of `frame`, built anew."""
        time_s = frame / float(self.option.fps)
        xf, inv = self._frame_transforms(time_s)
        fs = build_frame_scene(self.device_scene, torch.as_tensor(xf, device=self.device),
                               torch.as_tensor(inv, device=self.device))
        return fs, xf, self._frame_camera(time_s)

    def render_frame(self, frame: int, deadline: Optional[float] = None,
                     checkpoint_path: Optional[str] = None) -> dict:
        """Render one frame with the engine of `option.engine`; returns
        [H,W,*] numpy AOVs (color, albedo, normal; the wavefront engine's
        also variance and count) plus 'spp_done', 'render_s', 'build_s'
        and 'n_traces'. DenoiseUpScale2X renders at half the option's size.

        Both engines share one frame loop: spp batches over pixel groups
        (the wavefront engine's contiguous chunks of at most
        FILM_CHUNK_PIXELS, the masked engine's MASKED_TILE-pixel tiles in
        swizzled order), sums per pixel with their own sample counts, and a
        predictive deadline. Its estimate is seconds per pixel-spp (an
        average of measured batches, kept per engine across frames). A
        frame's first batch always completes, so every pixel has a sample;
        the masked engine's first shrinks to what the estimate says fits,
        as the JAX package's does. Before each group of a later batch the
        frame stops if that group's batch would not fit (a cut batch stays
        unbiased, every pixel divides by its own count).

        With `checkpoint_path`, the sums are saved after every spp batch,
        and a checkpoint of the same frame and size found there is resumed
        from. In a process group only rank 0 writes it; every process of a
        sharded frame reads it (all must start from the same spp_done),
        and only rank 0 reads it for a frame that is not sharded.

        On the wavefront engine with ``adaptive``, the first batch is
        uniform and every later one gives each pixel group's budget out by
        `_adaptive_allocation` over the sums so far. Sharded (see the
        module docstring), a batch of `cur` spp per process advances the
        frame by cur times the group's size, as the JAX package's sharded
        step does."""
        opt = self.option
        width, height = opt.image_width, opt.image_height
        if opt.render_mode == RenderMode.DENOISE_UPSCALE2X:
            width, height = width // 2, height // 2
        n = width * height
        t0 = time.monotonic()
        with span("frame.scene"):
            # no FrameScene of an earlier frame lives into this one's build
            self._frame_kept = None
            frame_scene, accel, cam = self.frame_scene(frame)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        build_s = time.monotonic() - t0
        engine = self._resolve_engine()
        make_step = self._make_wavefront_step if engine == "wavefront" else self._make_masked_step
        step, groups = make_step(frame_scene, accel, cam, width, height, frame)
        adaptive = engine == "wavefront" and bool(opt.adaptive)
        n_dev, rank = self._shards(adaptive)
        # the real rank: checkpoints are rank 0's to write, and to read
        # alone when the frame is not sharded
        real_rank0 = sharding.world()[1] == 0

        # color, albedo, normal, the per-sample luminance squares and counts
        sums = [np.zeros((n, 3), np.float32) for _ in range(3)] + \
            [np.zeros((n,), np.float32) for _ in range(2)]
        spp_done = 0
        if checkpoint_path and (n_dev > 1 or real_rank0) and os.path.exists(checkpoint_path):
            with np.load(checkpoint_path) as ck:
                # another frame or size, or a checkpoint without the second
                # moments and counts: ignored, the frame starts over
                if (int(ck["frame"]) == frame and ck["color"].shape == (n, 3)
                        and "m2" in ck and "cnt" in ck):
                    sums = [ck[k] for k in self._CKPT_SUMS]
                    spp_done = int(ck["spp_done"])
                    log.info("resumed frame %d at %d spp from %s", frame, spp_done,
                             checkpoint_path)
        traces = 0
        batch = max(1, opt.spp_batch)
        est = self._est_px_spp.get(engine)
        with span("frame.render"):
            t0 = time.monotonic()
            stop = False
            while spp_done < opt.max_spp:
                # spp per process: a batch advances the frame by cur * n_dev
                cur = min(batch, max(1, -(-(opt.max_spp - spp_done) // n_dev)))
                if (engine == "masked" and deadline is not None and spp_done == 0
                        and est is not None):
                    left = deadline - (time.monotonic() - t0)
                    cur = self._rank0(max(1, min(cur, int(left / max(est * n, 1e-12)))), n_dev)
                t_batch = time.monotonic()
                px_done = 0
                for index, arg, npix in groups:
                    if deadline is not None and spp_done > 0 and est is not None:
                        stop = bool(self._rank0(
                            int(time.monotonic() - t0 + est * npix * cur > deadline), n_dev))
                        if stop:
                            break
                    kw = {}
                    if adaptive:
                        color, _, _, m2, cnt = (x[index] for x in sums)
                        counts = (_adaptive_allocation(npix * cur, color, m2, cnt,
                                                       metric=opt.adaptive_metric)
                                  if spp_done > 0 else np.full((npix,), cur, np.int32))
                        kw = dict(counts=torch.from_numpy(counts),
                                  cbase=torch.from_numpy(cnt.astype(np.int32)))
                    with span("engine.step"):
                        out = step(arg, spp_done + rank * cur, cur, **kw)
                    if n_dev > 1:
                        out = sharding.all_reduce_film(out)
                    with span("frame.film_readback"):
                        for acc, x in zip(sums, out[:5]):
                            acc[index] += x.cpu().numpy()
                        traces += int(out[5])
                    px_done += npix
                if px_done:
                    per = (time.monotonic() - t_batch) / (px_done * cur)
                    est = per if est is None else 0.5 * est + 0.5 * per
                    self._est_px_spp[engine] = est
                if stop:
                    log.warning("frame %d: deadline hit at %d/%d spp (+%d/%d pixels of the next "
                                "batch)", frame, spp_done, opt.max_spp, px_done, n)
                    break
                spp_done += cur * n_dev
                if checkpoint_path and real_rank0:
                    # a temp file, then an atomic rename: a kill mid-write
                    # leaves the previous checkpoint whole
                    with span("frame.checkpoint"):
                        np.savez(checkpoint_path + ".tmp.npz", frame=frame, spp_done=spp_done,
                                 **dict(zip(self._CKPT_SUMS, sums)))
                        os.replace(checkpoint_path + ".tmp.npz", checkpoint_path)
                if deadline is not None and self._rank0(
                        int(time.monotonic() - t0 > deadline), n_dev):
                    log.warning("frame %d: deadline hit at %d/%d spp", frame, spp_done,
                                opt.max_spp)
                    break
        render_s = time.monotonic() - t0
        log.info("frame %d %s[%s%s%s]: %.2fs (%d spp, %.1f Mtraces, %.1f Mrays/s)", frame,
                 engine, self.integrator if engine == "masked" or self.integrator != "mis"
                 else opt.mis_mode, "+adaptive" if adaptive else "",
                 f" x{n_dev} processes" if n_dev > 1 else "", render_s, spp_done,
                 traces / 1e6, traces / max(render_s, 1e-9) / 1e6)
        color, albedo, normal, m2, cnt = sums
        inv = (1.0 / np.maximum(cnt, 1.0))[:, None].astype(np.float32)
        mu = color * inv
        out = {
            "color": mu.reshape(height, width, 3),
            "albedo": (albedo * inv).reshape(height, width, 3),
            "normal": (normal * inv).reshape(height, width, 3),
            "spp_done": spp_done,
            "render_s": render_s,
            "n_traces": traces,
            "build_s": build_s,
        }
        if engine == "wavefront":
            # the masked film, as the JAX package's, has no variance or
            # count AOV: DenoiseTemporal blends it without merging history
            lum = 0.2126 * mu[:, 0] + 0.7152 * mu[:, 1] + 0.0722 * mu[:, 2]
            var_mean = np.maximum(m2 * inv[:, 0] - lum * lum, 0.0) * inv[:, 0]
            out.update(variance=var_mean.reshape(height, width),
                       count=cnt.reshape(height, width))
        return out

    def _shards(self, adaptive: bool):
        """(process count, this process's rank) the frame's samples are
        sharded over: the `torch.distributed` group with
        ``multichip="auto"``, unless adaptive allocation renders
        unsharded; else (1, 0). A frame left unsharded inside a group is
        rank 0's alone: `initialize_and_render` skips it on every other
        process."""
        size, rank = sharding.world()
        if size <= 1 or self.option.multichip != "auto":
            return 1, 0
        if adaptive:
            if not self._warned_adaptive_shard:
                log.info("adaptive sampling: multi-GPU spp sharding disabled "
                         "(per-batch count lists are planned on the host)")
                self._warned_adaptive_shard = True
            return 1, 0
        return size, rank

    @staticmethod
    def _rank0(value: int, n_dev: int) -> int:
        """Rank 0's `value` when sharded over n_dev > 1 processes (every
        process must take the same batches and groups), else `value`."""
        return sharding.broadcast_int(value) if n_dev > 1 else value

    def _resolve_engine(self) -> str:
        """The engine of `option.engine`: "auto" is the wavefront engine on
        every device (the JAX package resolves it to the masked engine on
        the CPU)."""
        engine = "wavefront" if self.option.engine == "auto" else self.option.engine
        if engine == "masked" and self.integrator == "mis" and self.option.mis_mode == "single":
            log.info("engine masked: MIS renders the two-sample (ref) estimator; "
                     "mis_mode='single' applies to the wavefront engine only")
        return engine

    def _firefly_clamp(self) -> float:
        """The per-sample luminance cap: auto (-1) is 64.0 in the Denoise
        render modes and off (0.0) in Default and Debug."""
        clamp = self.option.firefly_clamp
        if clamp < 0.0:
            clamp = 64.0 if self.option.render_mode in DENOISE_MODES else 0.0
        return clamp

    def _make_wavefront_step(self, frame_scene, accel, cam, width, height, frame):
        """The wavefront engine's (step, groups) for `render_frame`: groups
        are contiguous pixel chunks, and `step((base, count), spp_start,
        spp_count, counts=None, cbase=None)` renders one through
        `wavefront_render` (persistent lanes that refill as paths end;
        `counts`/`cbase` its adaptive sample counts and bases) and returns
        its film's sums and traces."""
        from henjou_torch.integrator import wavefront

        opt = self.option
        integrator = self.integrator
        # a power-of-two pool: the bitonic sort takes n = 2^m >= 1024
        lanes = min(1 << 16, max(1 << 12, 1 << (width * height - 1).bit_length()))
        mis_single = integrator == "mis" and opt.mis_mode != "ref"
        clamp = self._firefly_clamp()
        intersect_fn, occluded_fn, pool_key_fn = self.scene_accel.wavefront_trace_fns(accel, lanes)
        light_isect_fn = (self.scene_accel.light_intersector(frame_scene)
                          if integrator == "mis" and not mis_single else None)
        seed = self._frame_seed(frame)
        plans: dict = {}  # this frame's lane pools and CUDA graphs, gone with the step

        def step(chunk, spp_start, spp_count, counts=None, cbase=None):
            base, count = chunk
            film = wavefront.wavefront_render(
                frame_scene, self.sky, cam, width, height, spp_count,
                self.bsdf_sample, bsdf_eval=self.bsdf_eval,
                bsdf_pdf=self.bsdf_pdf, integrator=integrator, seed=seed, lanes=lanes,
                intersect_fn=intersect_fn, occluded_fn=occluded_fn, pool_key_fn=pool_key_fn,
                light_isect_fn=light_isect_fn, spp_offset=spp_start, mis_single=mis_single,
                pixel_base=base, pixel_count=count, sample_counts=counts, sample_base=cbase,
                firefly_clamp=clamp, light_ris=opt.light_ris, sobol=self._sobol(),
                plans=plans,
            )
            return film.color, film.albedo, film.normal, film.m2, film.count, film.n_traces

        chunks = _pixel_chunks(width * height, self.FILM_CHUNK_PIXELS)
        return step, [(slice(b, b + c), (b, c), c) for b, c in chunks]

    def _integrate(self, frame_scene, o, d, state, intersect_fn, occluded_fn):
        """One spp of the selected integrator over a lane batch."""
        if self.integrator == "pathtrace":
            from henjou_torch.integrator.pathtrace import pathtrace

            return pathtrace(frame_scene, self.sky, o, d, state, self.bsdf_sample,
                             intersect_fn=intersect_fn)
        if self.integrator == "nee":
            from henjou_torch.integrator.nee import nee

            return nee(frame_scene, self.sky, o, d, state, self.bsdf_sample, self.bsdf_eval,
                       intersect_fn=intersect_fn, occluded_fn=occluded_fn)
        if self.integrator == "mis":
            from henjou_torch.integrator.mis import mis

            return mis(frame_scene, self.sky, o, d, state, self.bsdf_sample, self.bsdf_eval,
                       self.bsdf_pdf, intersect_fn=intersect_fn, occluded_fn=occluded_fn)
        raise ValueError(f"unknown integrator {self.integrator}")

    def _make_masked_step(self, frame_scene, accel, cam, width, height, frame):
        """The masked engine's (step, groups) for `render_frame`: groups are
        MASKED_TILE-pixel tiles in swizzled order, and `step(pixel_idx,
        spp_start, spp_count)` runs, per spp, a CMJ state, the camera rays
        and one pass of the integrator's depth loop over the tile's pixels
        ([R] i64 on the device), and returns the sums (lte, albedo, normal
        [R,3]; luminance squares, counts [R]) and the traces (0-d i64)."""
        from henjou_torch.runtime.camera import camera_rays
        from henjou_torch.sampling.cmj import make_cmj_state

        fns = self.scene_accel.trace_fns(accel)
        seed = self._frame_seed(frame)

        def step(pixel_idx, spp_start, spp_count):
            c = torch.zeros((pixel_idx.shape[0], 3), dtype=torch.float32, device=self.device)
            a, nm = torch.zeros_like(c), torch.zeros_like(c)
            m2 = torch.zeros_like(c[:, 0])
            traces = torch.zeros((), dtype=torch.int64, device=self.device)
            for i in range(spp_count):
                with span("engine.spawn"):
                    state = make_cmj_state(spp_start + i, pixel_idx, seed, sobol=self._sobol())
                    o, d, state = camera_rays(cam, width, height, pixel_idx, state)
                res = self._integrate(frame_scene, o, d, state, *fns)
                with span("engine.film"):
                    lum = (res.lte[:, 0] * 0.2126 + res.lte[:, 1] * 0.7152
                           + res.lte[:, 2] * 0.0722)
                    c, a, nm = c + res.lte, a + res.aov_albedo, nm + res.aov_normal
                    m2 = m2 + lum * lum
                    traces = traces + res.n_traces
            return c, a, nm, m2, torch.full_like(m2, float(spp_count)), traces

        order = _swizzled_pixel_order(width, height)
        tiles = [order[b:b + self.MASKED_TILE] for b in range(0, order.shape[0], self.MASKED_TILE)]
        return step, [(t, torch.from_numpy(t).to(self.device), t.shape[0]) for t in tiles]

    # ---------------- debug mode ----------------

    def render_debug(self, frame: int) -> dict:
        """Debug render mode: first-hit position, basecolor, normal and
        texcoord AOV images of one jittered sample per pixel, traced by
        brute force as the reference does."""
        from henjou_torch.integrator.payload import closest_hit
        from henjou_torch.runtime.camera import camera_rays
        from henjou_torch.sampling.cmj import make_cmj_state

        opt = self.option
        width, height = opt.image_width, opt.image_height
        frame_scene, _, cam = self._frame_geometry(frame)
        pix = torch.arange(width * height, dtype=torch.int64, device=self.device)
        st = make_cmj_state(torch.zeros_like(pix), pix, opt.seed)
        o, d, st = camera_rays(cam, width, height, pix, st)
        hit = closest_hit(frame_scene, self.sky, o, d)
        return {
            "position": hit.position.reshape(height, width, 3).cpu().numpy(),
            "basecolor": hit.basecolor.reshape(height, width, 3).cpu().numpy(),
            "normal": hit.normal.reshape(height, width, 3).cpu().numpy(),
            "texcoord": hit.texcoord.reshape(height, width, 2).cpu().numpy(),
        }

    # ---------------- full run ----------------

    def initialize_and_render(self, option_path: Optional[str] = None) -> list:
        """The entry point: the hardware canary (on CUDA, unless
        HENJOU_SKIP_CANARY=1), load (if given a path), build, then every
        frame inside the option's time budget: render (checkpointed after
        every spp batch), finalize in the configured mode and write one PNG
        per frame (four per frame in Debug mode). Returns the written
        paths. In a `torch.distributed` group only rank 0 finalizes and
        writes; the other processes render their shares of sharded frames,
        skip the frames that are not sharded (see `_shards`; their
        frame_stats entry has spp 0) and return no paths."""
        overall_t0 = time.monotonic()
        if self.device.type == "cuda" and os.environ.get("HENJOU_SKIP_CANARY", "0") != "1":
            # known-answer render through the kernels before the budget is
            # spent; raises when the film is off
            from henjou_torch.runtime.canary import canary_check

            res = canary_check(self.device, strict=True)
            self.setup_stats["canary_rmse"] = res["rmse"]
            self.setup_stats["canary_s"] = time.monotonic() - overall_t0
        if option_path:
            self.load_render_option(option_path)
            self._load_scene_from_option()
        if self.device_scene is None:
            self.build()
        opt = self.option
        writer = sharding.world()[1] == 0
        # inside a group, a frame that is not sharded is rank 0's alone
        sharded = self._shards(self._resolve_engine() == "wavefront" and bool(opt.adaptive))[0] > 1
        budget_s = opt.time_limit * 60.0
        stamp = time.strftime("%Y%m%d-%H%M%S") + "_" if opt.use_date else ""

        written = []
        # measured non-render overhead of the previous frame (finalize and
        # PNG included), reserved off every later frame's deadline so the
        # whole animation fits
        overhead_est = 0.0
        for frame in range(opt.start_frame, opt.end_frame):
            t0 = time.monotonic()
            if opt.render_mode == RenderMode.DEBUG:
                if not writer:
                    continue
                dbg = self.render_debug(frame)
                for key in ("position", "basecolor", "normal", "texcoord"):
                    img = dbg[key]
                    if img.shape[-1] == 2:
                        img = np.concatenate([img, np.zeros_like(img[..., :1])], -1)
                    u8 = float_to_srgb_u8(torch.as_tensor(np.abs(img))).numpy()
                    path = os.path.join(opt.image_directory,
                                        f"{stamp}{opt.image_name}_{key}_{frame:03d}.png")
                    write_png(path, u8)
                    written.append(path)
                continue
            if not writer and not sharded:
                self.frame_stats.append(dict(frame=frame, spp=0, render_s=0.0))
                continue
            timer.take()  # what was recorded before this frame is not its own
            remaining = budget_s - (t0 - overall_t0)
            frames_left = max(opt.end_frame - frame, 1)
            out_dir = os.path.join(opt.image_directory, os.path.dirname(opt.image_name))
            ckpt = os.path.join(out_dir,
                                f".{os.path.basename(opt.image_name)}_{frame:03d}.ckpt.npz")
            deadline = max((remaining - overhead_est * frames_left) / frames_left, 1.0)
            if frame == opt.start_frame and budget_s < float("inf"):
                # the first frame's overhead is unknown: under-allocate it
                deadline *= 0.6
            aovs = self.render_frame(frame, deadline=deadline, checkpoint_path=ckpt)
            if not writer:
                self.frame_stats.append(_with_spans(dict(frame=frame, spp=aovs["spp_done"],
                                                         render_s=aovs["render_s"])))
                continue
            t_fin = time.monotonic()
            img = self._finalize(aovs, frame=frame)
            finalize_s = time.monotonic() - t_fin
            with span("frame.output"):
                if os.path.exists(ckpt):
                    os.remove(ckpt)  # frame complete
                u8 = float_to_srgb_u8(torch.as_tensor(img)).numpy()
                name = f"{stamp}{opt.image_name}_{frame:03d}.png"
                path = os.path.join(opt.image_directory, name)
                write_png(path, u8)
            written.append(path)
            frame_total = time.monotonic() - t0
            overhead_est = frame_total - float(aovs["render_s"])
            self.frame_stats.append(_with_spans(dict(
                frame=frame, spp=aovs["spp_done"], render_s=aovs["render_s"],
                build_s=aovs["build_s"], n_traces=aovs["n_traces"],
                finalize_s=finalize_s, finalize_png_s=time.monotonic() - t_fin,
                total_s=frame_total, path=path, film_shape=list(aovs["color"].shape[:2]),
                film_finite=bool(np.isfinite(aovs["color"]).all()),
                film_mean=float(aovs["color"].mean()),
                image_finite=bool(np.isfinite(img).all()),
            )))
            log.info(
                "frame %d: %d spp in %.2fs (render %.2fs, finalize %.2fs, overhead %.2fs) -> %s",
                frame, aovs["spp_done"], frame_total, aovs["render_s"], finalize_s,
                overhead_est, path,
            )
        log.info("animation done: %.2fs / budget %.2fs", time.monotonic() - overall_t0, budget_s)
        return written

    # ---------------- finalize (denoiser and probes) ----------------

    def _finalize(self, aovs: dict, frame: int = None) -> np.ndarray:
        """The displayed [H,W,3] image of a frame's AOVs. Default: the raw
        colour AOV. Denoise: the spatial filter. DenoiseUpScale2X: the
        spatial filter, then the 2x upscale guided by a full-resolution
        first-hit probe. DenoiseTemporal: temporal accumulation or
        reprojection against the previous frame, restarting spatially
        when the frame does not follow it. Debug: the albedo AOV."""
        with span("frame.finalize"):
            mode = self.option.render_mode
            if mode == RenderMode.DEBUG:
                return aovs["albedo"]
            if mode not in DENOISE_MODES:
                return aovs["color"]
            from henjou_torch.post import denoise as dn

            # the AOVs go up to the device once per frame
            with span("finalize.upload"):
                dev = {k: (torch.as_tensor(aovs[k], dtype=torch.float32, device=self.device)
                           if aovs.get(k) is not None else None)
                       for k in ("color", "albedo", "normal", "variance", "count")}
            if mode == RenderMode.DENOISE_TEMPORAL:
                out = self._finalize_temporal(dev, frame)
            else:
                with span("finalize.denoise"):
                    out = self._spatial_denoise(dev)
                if mode == RenderMode.DENOISE_UPSCALE2X:
                    guides = self._full_res_guides(frame)
                    with span("finalize.denoise"):
                        out = (dn.upscale2x_guided(out, dev["albedo"], dev["normal"], *guides)
                               if guides is not None else dn.upscale2x(out))
            with span("finalize.readback"):
                return out.cpu().numpy()

    def _finalize_temporal(self, dev: dict, frame):
        """DenoiseTemporal on the device tensors `dev`. History is used only
        for the frame right after the previous one, at the same size. With
        the depth probe's reprojection and the wavefront film's variance and
        counts it merges the warped raw history into the film before the
        spatial filter (`temporal_accumulate`); without a banked raw film it
        blends the reprojected previous output
        (`denoise_temporal_reprojected`); without a reprojection, the
        unwarped previous output (`denoise_temporal`)."""
        from henjou_torch.post import denoise as dn

        color, albedo, normal = dev["color"], dev["albedo"], dev["normal"]
        prev = self._temporal_history
        prev_frame = self._temporal_prev_frame
        # an unknown frame index cannot prove adjacency: restart spatially
        sequential = frame is not None and prev_frame is not None and frame == prev_frame + 1
        cam = pos = hitm = None
        if frame is not None and self.device_scene is not None:
            # the depth probe for motion-compensated history, also on the
            # first frame so its camera is banked for the next
            with span("finalize.probe"):
                frame_scene, accel, cam = self.frame_scene(frame)
                pos, hitm = _temporal_depth_probe(frame_scene, self.sky, cam, accel,
                                                  color.shape[1], color.shape[0])
        with span("finalize.denoise"):
            prev_cam = self._temporal_prev_cam
            # pre-filter accumulation state: (raw mean, variance of the mean,
            # effective count, albedo, normal)
            raw_hist = self._temporal_raw
            variance, cnt = dev["variance"], dev["count"]
            have_film = variance is not None and cnt is not None
            new_raw = None
            if prev is None or prev[0].shape != color.shape or not sequential:
                out = self._spatial_denoise(dev)
            elif cam is not None and prev_cam is not None and pos is not None:
                from henjou_torch.runtime.camera import project_to_pixel

                h, w = color.shape[0], color.shape[1]
                px, py, infront = project_to_pixel(prev_cam, pos.reshape(-1, 3), w, h)
                px = px.reshape(h, w)
                py = py.reshape(h, w)
                valid = infront.reshape(h, w) & hitm
                if have_film and raw_hist is not None and raw_hist[0].shape == color.shape:
                    merged, var_m, n_eff = dn.temporal_accumulate(
                        color, variance, cnt, albedo, normal, *raw_hist, px, py, valid)
                    out = self._spatial_denoise(dict(dev, color=merged, variance=var_m))
                    new_raw = (merged, var_m, n_eff, albedo, normal)
                else:
                    out = dn.denoise_temporal_reprojected(
                        color, albedo, normal, *prev, px, py, valid,
                        spatial=self._spatial_denoise(dev))
            else:
                out = dn.denoise_temporal(color, albedo, normal, *prev,
                                          spatial=self._spatial_denoise(dev))
            if new_raw is None and have_film:
                new_raw = (color, variance, cnt, albedo, normal)
        self._temporal_raw = new_raw
        self._temporal_history = (out, albedo, normal)
        self._temporal_prev_frame = frame
        self._temporal_prev_cam = cam
        return out

    def _spatial_denoise(self, dev: dict):
        """The spatial pass on the device tensors `dev`: variance-guided
        (SVGF) à-trous when the film has the variance AOV (always, from the
        wavefront engine), fixed-sigma à-trous otherwise."""
        from henjou_torch.post.denoise import denoise_atrous, denoise_atrous_var

        if dev.get("variance") is not None:
            return denoise_atrous_var(dev["color"], dev["albedo"], dev["normal"],
                                      dev["variance"])
        return denoise_atrous(dev["color"], dev["albedo"], dev["normal"])

    def _full_res_guides(self, frame: int = None):
        """(albedo[H,W,3], normal[H,W,3]) of a pixel-centre first-hit probe
        at the output size, the guides of the 2x upsample; None without a
        device scene (the caller then upscales bilinearly)."""
        if self.device_scene is None:
            return None
        with span("finalize.probe"):
            frame_scene, accel, cam = self.frame_scene(frame or 0)
            opt = self.option
            return _guide_probe(frame_scene, self.sky, cam, accel, opt.image_width,
                                opt.image_height)

    def _load_scene_from_option(self):
        opt = self.option
        path = os.path.join(opt.gltf_path, opt.gltf_name)
        t0 = time.monotonic()
        if path.lower().endswith((".gltf", ".glb")):
            from henjou_torch.scene.gltf import load_gltf

            self.set_scene(load_gltf(path))
        elif path.lower().endswith(".obj"):
            from henjou_torch.scene.obj import load_obj

            self.set_scene(load_obj(path))
        else:
            raise ValueError(f"unsupported scene file: {path}")
        self.setup_stats["load_s"] = time.monotonic() - t0
        self.build()


def _with_spans(entry: dict) -> dict:
    """A frame_stats entry with the spans and counters recorded during its
    frame (`utils/timer.py`), where there were any."""
    spans, counts = timer.take()
    if spans:
        entry["spans"] = spans
    if counts:
        entry["counters"] = counts
    return entry


PROBE_CHUNK = 1 << 16


def _chunked_closest_hit(frame_scene, sky, o, d, intersect_fn, chunk: int = PROBE_CHUNK):
    """closest_hit over [R,3] rays in chunks of `chunk` rays, the engine's
    launch shape: the last chunk is padded (origin 0, direction +y) and
    the padding stripped. Returns a SurfaceHit with [R] leaves."""
    from henjou_torch.integrator.payload import SurfaceHit, closest_hit

    r = o.shape[0]
    if r <= chunk:
        return closest_hit(frame_scene, sky, o, d, intersect_fn=intersect_fn)
    pad = (-r) % chunk
    if pad:
        o = torch.cat([o, torch.zeros((pad, 3), dtype=o.dtype, device=o.device)])
        d = torch.cat([d, torch.tensor([[0.0, 1.0, 0.0]], dtype=d.dtype,
                                       device=d.device).expand(pad, 3)])
    parts = [closest_hit(frame_scene, sky, o[b:b + chunk], d[b:b + chunk],
                         intersect_fn=intersect_fn)
             for b in range(0, o.shape[0], chunk)]
    return SurfaceHit(*(torch.cat(leaves)[:r] for leaves in zip(*parts)))


def _probe_hit(frame_scene, sky, cam, accel, width, height):
    """Pixel-centre first hits of a width x height frame: the raw binned
    intersector (pixel-centre rays are already coherent, so no sort), or
    brute force without an accel."""
    from henjou_torch.runtime.camera import camera_rays_centers

    ifn = None
    if accel is not None:
        from henjou_torch.accel.pallas_binned import make_binned_intersector

        ifn, _ = make_binned_intersector(accel)
    o, d = camera_rays_centers(cam, width, height)
    return _chunked_closest_hit(frame_scene, sky, o, d, ifn)


def _guide_probe(frame_scene, sky, cam, accel, width, height):
    """First-hit (albedo[H,W,3], normal[H,W,3]) at the full output size:
    the guides of `upscale2x_guided`, in the domain of the engine's
    first-bounce AOVs."""
    hit = _probe_hit(frame_scene, sky, cam, accel, width, height)
    return hit.basecolor.reshape(height, width, 3), hit.normal.reshape(height, width, 3)


def _temporal_depth_probe(frame_scene, sky, cam, accel, width, height):
    """First-hit world positions for temporal reprojection: ([H,W,3]
    position, [H,W] hit mask)."""
    hit = _probe_hit(frame_scene, sky, cam, accel, width, height)
    return hit.position.reshape(height, width, 3), hit.is_hit.reshape(height, width)
