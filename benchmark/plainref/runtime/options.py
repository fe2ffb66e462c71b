"""Render options: the same JSON schema as the reference.

Port of henjou_tpu/runtime/options.py: host code, copied. The option
file's "TPU" section keeps its name (it is the file schema); the port
renders every value the JAX package's loader accepts.

Parses render_option.json with the reference's section layout
(include/loader/render_json_loader.h:78-228) into a frozen dataclass
(include/renderer/render_option.h:45-84), including the fps.txt side-channel
override (render_json_loader.h:164-171). PTX_File is accepted and ignored.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import logging
import math
import os
from typing import Tuple

log = logging.getLogger("plainref")


class RenderMode(enum.Enum):
    # reference: render_option.h:38-43
    DEFAULT = "Default"
    DENOISE = "Denoise"
    DENOISE_UPSCALE2X = "DenoiseUpScale2X"
    DEBUG = "Debug"
    # additive: the reference's DenoiseType::TEMPORAL exists
    # (denoiser.h:37) but no RenderMode selects it (renderer.h:1109-1115);
    # this mode makes the latent capability reachable from config
    DENOISE_TEMPORAL = "DenoiseTemporal"


@dataclasses.dataclass(frozen=True)
class RenderOption:
    image_width: int = 1024
    image_height: int = 1024
    image_name: str = "test"
    image_directory: str = "./"
    max_spp: int = 100

    gltf_path: str = "./"
    gltf_name: str = "test.gltf"

    fps: int = 24
    start_frame: int = 0
    end_frame: int = 1
    time_limit: float = 1.0  # minutes (renderer.h:1073: seconds = limit*60)

    allow_camera_animation: bool = False
    camera_fov: float = math.radians(45.0)
    camera_position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    camera_direction: Tuple[float, float, float] = (0.0, 0.0, -1.0)
    camera_animation_id: int = -1

    render_mode: RenderMode = RenderMode.DEFAULT

    use_ibl: bool = False
    ibl_path: str = ""
    ibl_intensity: float = 1.0
    scene_sky_default: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    use_date: bool = False
    save_render_option: bool = False

    lut_path: str = ""

    # TPU-specific knobs (absent in the reference; defaults keep parity)
    spp_batch: int = 16  # samples per jitted step (compile-time/ckpt batching)
    seed: int = 0
    integrator: str = "mis"  # pathtrace | nee | mis (rt.h:85,162,284)
    # auto -> wavefront on TPU (3.2x the masked loop's honest Mrays/s,
    # pixel-exact), masked on CPU (fast compile for tests/tools)
    engine: str = "auto"  # auto | masked (depth loop) | wavefront (refill)
    # MIS estimator: "single" = one-sample (shared BSDF draw; the path
    # continuation IS the MIS branch, deleting one any-hit kernel walk
    # and one BSDF draw per bounce — same integral, standard Veach MIS);
    # "ref" = the reference's two-sample form (rt.h:284-440), used by
    # the estimator-parity tests. Wavefront engine only: the masked
    # depth-loop engine always renders the ref form.
    mis_mode: str = "single"
    # adaptive per-pixel sample allocation (wavefront engine only): after
    # a uniform warm-up batch, each batch's sample budget is drawn
    # proportional to the per-pixel relative-variance estimate. Unbiased
    # per pixel (every pixel divides by its own count); the reference
    # brute-forces uniform max_spp instead (renderer.h:1183,1241).
    # Default OFF: measured round 4 (BASELINE.md quality ledger), the
    # tuned SVGF denoises the UNIFORM film better in both linear and
    # sRGB space (post-SVGF sRGB 0.01217 uniform vs 0.01238 adaptive);
    # adaptive only wins raw display-referred error (-4.6% sRGB), so
    # enable it for non-denoised outputs, not the Denoise artifact path.
    adaptive: bool = False
    # allocation weight: "relstd" targets display-referred error
    # (sigma/mean), "std" targets absolute linear-HDR error (n ~ sigma
    # is the optimal fixed-budget split for mean squared error).
    adaptive_metric: str = "relstd"
    # per-sample luminance cap (wavefront engine): kills fireflies no
    # finite spp can average away. -1 = auto (64.0 in the Denoise render
    # modes, off in Default/Debug — parity-sensitive runs see unclamped
    # estimates); 0 = always off; >0 = explicit cap.
    firefly_clamp: float = -1.0
    # sample generator: "cmj" = the reference's 4x4 CMJ (cmj.h,
    # bit-exact port; pixel-exact parity runs use this), "sobol" =
    # padded Owen-scrambled Sobol (sampling/sobol.py) — stratified at
    # every power-of-two prefix, lower RMSE per sample in the 32-500
    # spp contest regime (measured in BASELINE.md round 4).
    sampler: str = "cmj"
    # RIS/WRS next-event light sampling (wavefront engine only): draw
    # this many light candidates per bounce, weight each by unshadowed
    # geometric contribution at the shading point, keep one, then cast
    # the single shadow ray as usual (sampling/light_sample.py
    # sample_light_ris). 0/1 = off (exactly one candidate, reference
    # stream parity). Unbiased for any m; pure dense VPU cost, no extra
    # traces. The reference draws exactly one uniform candidate
    # (light_sample.h:40).
    light_ris: int = 0
    # multi-chip scaling (wavefront engine): "auto" spp-shards every
    # chunk step over ALL visible devices when more than one exists —
    # device k renders sample indices [spp + k*cur, spp + (k+1)*cur) of
    # every pixel and the partial films psum over ICI
    # (runtime/sharding.py semantics, wired into the production frame
    # loop). "off" keeps the reference's single-device execution
    # (renderer.h:1241 is one GPU) regardless of visible devices.
    multichip: str = "auto"


def _load_fps_txt(path: str):
    # reference: render_json_loader.h:14-34 — last line wins
    try:
        with open(path) as f:
            fps = None
            for line in f:
                line = line.strip()
                if line:
                    fps = int(line)
            return fps
    except (OSError, ValueError):
        return None


def load_render_option(filepath: str) -> RenderOption:
    with open(filepath) as f:
        j = json.load(f)

    img = j["Image"]
    cam = j["Camera"]
    anim = j["Animation"]
    sky = j["Sky"]
    opt = j.get("Option", {})
    gltf = j["GLTF_file"]

    mode_str = j.get("Render_mode", "Default")
    try:
        mode = RenderMode(mode_str)
    except ValueError:
        mode = RenderMode.DEFAULT  # render_json_loader.h:133-136 fallback

    fps = int(anim["fps"])
    # fps.txt in the option file's directory, then CWD (reference reads ./fps.txt)
    for cand in (
        os.path.join(os.path.dirname(os.path.abspath(filepath)), "fps.txt"),
        "./fps.txt",
    ):
        override = _load_fps_txt(cand)
        if override is not None:
            log.info("fps.txt override: %d (from %s)", override, cand)
            fps = override
            break

    # TPU-section enums: fail loudly on typos ("reference", "two-sample",
    # "wave" ...) instead of silently selecting a default estimator/engine
    tpu = j.get("TPU", {})
    mis_mode = str(tpu.get("mis_mode", "single"))
    if mis_mode not in ("single", "ref"):
        raise ValueError(
            f"TPU.mis_mode must be 'single' or 'ref', got {mis_mode!r}"
        )
    engine = str(tpu.get("engine", "auto"))
    if engine not in ("auto", "masked", "wavefront"):
        raise ValueError(
            f"TPU.engine must be auto|masked|wavefront, got {engine!r}"
        )
    integrator = str(tpu.get("integrator", "mis"))
    if integrator not in ("pathtrace", "nee", "mis"):
        raise ValueError(
            f"TPU.integrator must be pathtrace|nee|mis, got {integrator!r}"
        )
    sampler = str(tpu.get("sampler", "cmj"))
    if sampler not in ("cmj", "sobol"):
        raise ValueError(f"TPU.sampler must be cmj|sobol, got {sampler!r}")
    adaptive_metric = str(tpu.get("adaptive_metric", "relstd"))
    if adaptive_metric not in ("relstd", "std"):
        raise ValueError(
            f"TPU.adaptive_metric must be relstd|std, got {adaptive_metric!r}"
        )
    light_ris = int(tpu.get("light_ris", 0))
    if not (0 <= light_ris <= 64):
        # <2 means off; each candidate stacks an [R,m,3] array per bounce,
        # so cap m at a sane bound instead of letting 10000 OOM the chip
        raise ValueError(
            f"TPU.light_ris must be in [0, 64] (0/1 = off), got {light_ris}"
        )
    multichip = str(tpu.get("multichip", "auto"))
    if multichip not in ("auto", "off"):
        raise ValueError(
            f"TPU.multichip must be auto|off, got {multichip!r}"
        )
    seed = int(tpu.get("seed", 0))
    if seed & 0x80000000:
        # bit 31 of the sampler seed is reserved for the Sobol tag
        # (sampling/cmj.py SOBOL_SEED_FLAG); the renderer masks it off on
        # the cmj path, which would silently alias this seed with its
        # low-31-bit counterpart — surface that instead of hiding it
        log.warning(
            "TPU.seed 0x%08x has bit 31 set (reserved for the sampler "
            "tag); the effective cmj seed is 0x%08x",
            seed & 0xFFFFFFFF,
            seed & 0x7FFFFFFF,
        )

    # config snapshot side-channel (render_json_loader.h:204-218)
    if bool(opt.get("save_renderOption", False)):
        import time as _time

        stamp = _time.strftime("%a %b %d %H%M%S %Y")
        snap = f"renderoption{stamp}.json"
        try:
            with open(snap, "w") as f:
                json.dump(j, f, indent=2)
            log.info("render option snapshot saved: %s", snap)
        except OSError as e:
            log.warning("could not save render option snapshot: %s", e)

    return RenderOption(
        image_width=int(img["image_width"]),
        image_height=int(img["image_height"]),
        image_name=str(img["image_name"]),
        image_directory=str(img["image_directory"]),
        max_spp=int(img["max_spp"]),
        gltf_path=str(gltf["gltf_filepath"]),
        gltf_name=str(gltf["gltf_filename"]),
        fps=fps,
        start_frame=int(anim["start_frame"]),
        end_frame=int(anim["end_frame"]),
        time_limit=float(anim["time_limit"]),
        allow_camera_animation=bool(cam["allow_camera_animation"]),
        camera_fov=math.pi * float(cam["camera_fov"]) / 180.0,  # json_loader.h:144
        camera_position=tuple(float(x) for x in cam["camera_position"]),
        camera_direction=tuple(float(x) for x in cam["camera_direction"]),
        render_mode=mode,
        use_ibl=bool(sky["use_IBL"]),
        ibl_path=str(sky["IBL_path"]),
        ibl_intensity=float(sky["IBL_intensity"]),
        scene_sky_default=tuple(float(x) for x in sky["scene_sky_default"]),
        use_date=bool(opt.get("use_date", False)),
        save_render_option=bool(opt.get("save_renderOption", False)),
        lut_path=str(j.get("LUT", {}).get("LUT_path", "")),
        spp_batch=int(tpu.get("spp_batch", 16)),
        seed=seed,
        integrator=integrator,
        engine=engine,
        mis_mode=mis_mode,
        adaptive=bool(tpu.get("adaptive", False)),
        adaptive_metric=adaptive_metric,
        firefly_clamp=float(tpu.get("firefly_clamp", -1.0)),
        sampler=sampler,
        light_ris=light_ris,
        multichip=multichip,
    )
