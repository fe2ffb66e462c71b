"""The plain reference renderer: the same option file, scene and seed as the
program, worked out again from scratch in plain PyTorch.

It loads the option and the glTF scene itself, builds the frame's
world-space triangles, camera, sky, light table and BSDF dispatch, traces
with the benchmark's own intersector (`accel/clusters.py`), and renders the
samples of any list of pixels: the wavefront engine's one-sample or
two-sample MIS (`integrator/wavefront.py`) or the masked engine's two-sample
depth loop (`integrator/mis.py`). The CMJ streams are keyed on (sample,
pixel, dimension, seed), so a pixel's samples are the ones a whole-frame
render draws. `finalize` applies the option's render mode to a film, with
its own first-hit depth probe for DenoiseTemporal.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from plainref.accel.clusters import PlainClusters, make_intersector
from plainref.integrator.payload import Sky, closest_hit
from plainref.runtime.camera import camera_rays, camera_rays_centers, make_camera
from plainref.runtime.options import RenderMode, load_render_option
from plainref.sampling.cmj import make_cmj_state
from plainref.scene.scenedata import build_device_scene, build_frame_scene, identity_transforms

DENOISE_MODES = (RenderMode.DENOISE, RenderMode.DENOISE_UPSCALE2X,
                 RenderMode.DENOISE_TEMPORAL)
PROBE_CHUNK = 1 << 16


class PlainRenderer:
    def __init__(self, option_path: str, device, trace_dtype=torch.float32,
                 storage_dtype=None):
        self.device = torch.device(device)
        self.trace_dtype = trace_dtype
        # the finalize's inputs (film, history, probe) rounded through this
        # dtype, for the control; None keeps them as given
        self.storage_dtype = storage_dtype
        self.option = opt = load_render_option(option_path)
        path = os.path.join(opt.gltf_path, opt.gltf_name)
        if not path.lower().endswith((".gltf", ".glb")):
            raise ValueError(f"the reference loads glTF scenes only, not {path}")
        from plainref.scene.gltf import load_gltf

        self.scene = load_gltf(path)
        self.device_scene = build_device_scene(self.scene, self.device)
        ibl = None
        if opt.use_ibl and opt.ibl_path and os.path.exists(opt.ibl_path):
            from plainref.texture.ibl import load_ibl

            ibl = load_ibl(opt.ibl_path, self.device)
        f32 = dict(dtype=torch.float32, device=self.device)
        self.sky = Sky(constant_color=torch.tensor(opt.scene_sky_default, **f32),
                       intensity=torch.tensor(opt.ibl_intensity, **f32),
                       use_ibl=ibl is not None, ibl_texture=ibl)
        from plainref.bsdf.dispatch import bsdf_eval, bsdf_pdf, make_bsdf_sampler
        from plainref.texture.lut import default_lut, load_lut_png

        lut = (load_lut_png(opt.lut_path, self.device)
               if opt.lut_path and os.path.exists(opt.lut_path) else default_lut(self.device))
        mats = self.scene.materials
        flags = dict(has_sheen=any(m["sheen"] > 0 for m in mats),
                     has_clearcoat=any(m["clearcoat"] > 0 for m in mats))
        lut = lut if any(m["is_thinfilm"] for m in mats) else None
        self.bsdf_sample = make_bsdf_sampler(
            lut, has_specular=any(m["ideal_specular"] for m in mats),
            has_metal=any(m["metallic"] > 0.5 or m["metallic_tex"] >= 0 for m in mats),
            **flags)
        self.bsdf_eval = lambda hit, wo, wi: bsdf_eval(hit, wo, wi, lut, **flags)
        self.bsdf_pdf = bsdf_pdf
        self._clusters = None

    # ---------------- per frame ----------------

    def size(self):
        opt = self.option
        if opt.render_mode == RenderMode.DENOISE_UPSCALE2X:
            return opt.image_width // 2, opt.image_height // 2
        return opt.image_width, opt.image_height

    def _transforms(self, time_s: float):
        from plainref.math.affine import invert_affine

        xf = identity_transforms(len(self.scene.instances))
        anims = self.scene.animations
        for i, inst in enumerate(self.scene.instances):
            if 0 <= inst.animation_id < len(anims):
                xf[i] = anims[inst.animation_id].get_affine(time_s)
        return xf, np.stack([invert_affine(m) for m in xf])

    def camera(self, frame: int):
        opt = self.option
        time_s = frame / float(opt.fps)
        fov = self.scene.camera_fov_from_file or opt.camera_fov
        anims = self.scene.animations
        cam_id = self.scene.camera_animation_id
        if opt.allow_camera_animation and 0 <= cam_id < len(anims):
            from plainref.math.affine import apply_affine_point, apply_affine_vector

            anim = anims[cam_id]
            pos = apply_affine_point(anim.get_affine(time_s), opt.camera_position)
            rot = anim.get_rotation_affine(time_s)
            d = apply_affine_vector(rot, opt.camera_direction)
            up = apply_affine_vector(rot, (0.0, 1.0, 0.0))
            d = d / np.linalg.norm(d)
            right = np.cross(d, up)
            right = right / np.linalg.norm(right)
            return make_camera(pos, d, fov, self.device, up=up, right=right)
        return make_camera(opt.camera_position, opt.camera_direction, fov, self.device)

    def frame_scene(self, frame: int):
        """(FrameScene, intersect_fn, occluded_fn, camera) of `frame`."""
        xf, inv = self._transforms(frame / float(self.option.fps))
        fs = build_frame_scene(self.device_scene, torch.as_tensor(xf, device=self.device),
                               torch.as_tensor(inv, device=self.device))
        key = xf.tobytes()
        if self._clusters is None or self._clusters[0] != key:
            self._clusters = (key, PlainClusters(fs.tri_verts))
        fns = make_intersector(self._clusters[1], self.trace_dtype)
        return (fs, *fns, self.camera(frame))

    def frame_seed(self, frame: int) -> int:
        return ((int(self.option.seed) + int(frame)) & 0xFFFFFFFF) & 0x7FFFFFFF

    def firefly_clamp(self) -> float:
        clamp = self.option.firefly_clamp
        if clamp < 0.0:
            clamp = 64.0 if self.option.render_mode in DENOISE_MODES else 0.0
        return clamp

    # ---------------- film ----------------

    def film(self, frame: int, pixel_ids: np.ndarray, spp: int, engine: str) -> dict:
        """Per-pixel means of samples 0..spp-1 of `pixel_ids` (global ids):
        {color, albedo, normal [P,3]; count [P]} as numpy."""
        fs, ifn, ofn, cam = self.frame_scene(frame)
        w, h = self.size()
        pix = torch.as_tensor(np.asarray(pixel_ids, np.int64), device=self.device)
        seed = self.frame_seed(frame)
        opt = self.option
        if engine == "wavefront":
            from plainref.integrator.wavefront import wavefront_render

            mis_single = self.option.integrator == "mis" and opt.mis_mode != "ref"
            f = wavefront_render(
                fs, self.sky, cam, w, h, spp, self.bsdf_sample, pix,
                bsdf_eval=self.bsdf_eval, bsdf_pdf=self.bsdf_pdf,
                integrator=opt.integrator, seed=seed, lanes=int(pix.shape[0]) * spp,
                intersect_fn=ifn, occluded_fn=ofn, mis_single=mis_single,
                firefly_clamp=self.firefly_clamp())
            sums = (f.color, f.albedo, f.normal, f.count)
        elif engine == "masked":
            from plainref.integrator.mis import mis

            c = torch.zeros((pix.shape[0], 3), dtype=torch.float32, device=self.device)
            a, nm = torch.zeros_like(c), torch.zeros_like(c)
            for i in range(spp):
                st = make_cmj_state(i, pix, seed)
                o, d, st = camera_rays(cam, w, h, pix, st)
                res = mis(fs, self.sky, o, d, st, self.bsdf_sample, self.bsdf_eval,
                          self.bsdf_pdf, intersect_fn=ifn, occluded_fn=ofn)
                c, a, nm = c + res.lte, a + res.aov_albedo, nm + res.aov_normal
            sums = (c, a, nm, torch.full_like(c[:, 0], float(spp)))
        else:
            raise ValueError(f"unknown engine {engine!r}")
        inv = (1.0 / torch.clamp(sums[3], min=1.0))[:, None]
        return {"color": (sums[0] * inv).cpu().numpy(), "albedo": (sums[1] * inv).cpu().numpy(),
                "normal": (sums[2] * inv).cpu().numpy(), "count": sums[3].cpu().numpy()}

    # ---------------- finalize ----------------

    def depth_probe(self, frame: int):
        """First-hit world positions [H,W,3] and hit mask [H,W] of the
        pixel-centre rays of `frame`."""
        fs, ifn, _, cam = self.frame_scene(frame)
        w, h = self.size()
        o, d = camera_rays_centers(cam, w, h)
        pos, hit = [], []
        for b in range(0, o.shape[0], PROBE_CHUNK):
            s = closest_hit(fs, self.sky, o[b:b + PROBE_CHUNK], d[b:b + PROBE_CHUNK],
                            intersect_fn=ifn)
            pos.append(s.position)
            hit.append(s.is_hit)
        return torch.cat(pos).reshape(h, w, 3), torch.cat(hit).reshape(h, w)

    def finalize(self, frame: int, film: dict, state: dict):
        """(the displayed [H,W,3] image, the history for the next frame) of
        `film` (numpy AOVs of the whole frame: color, albedo, normal, and
        variance and count where the engine has them) in the option's
        render mode. `state` is the DenoiseTemporal history the frame
        starts from, as this method returned it for the frame before:
        {history, raw, prev_frame}, or {} for none."""
        mode = self.option.render_mode
        if mode == RenderMode.DEBUG:
            return film["albedo"], {}
        if mode not in DENOISE_MODES:
            return film["color"], {}
        if mode != RenderMode.DENOISE_TEMPORAL:
            raise ValueError(f"the reference finalizes {mode} only without DenoiseUpScale2X")
        from plainref.post import denoise as dn

        dev = {k: (self._stored(torch.as_tensor(film[k], dtype=torch.float32,
                                                device=self.device))
                   if film.get(k) is not None else None)
               for k in ("color", "albedo", "normal", "variance", "count")}
        color, albedo, normal = dev["color"], dev["albedo"], dev["normal"]
        prev = self._stored(state.get("history"))
        raw_hist = self._stored(state.get("raw"))
        prev_frame = state.get("prev_frame")
        sequential = prev_frame is not None and frame == prev_frame + 1
        variance, cnt = dev["variance"], dev["count"]
        have_film = variance is not None and cnt is not None
        new_raw = None
        if prev is None or prev[0].shape != color.shape or not sequential:
            out = self._spatial(dev)
        else:
            from plainref.runtime.camera import project_to_pixel

            pos, hitm = self.depth_probe(frame)
            pos = self._stored(pos)
            prev_cam = self.camera(prev_frame)
            h, w = color.shape[0], color.shape[1]
            px, py, infront = project_to_pixel(prev_cam, pos.reshape(-1, 3), w, h)
            px, py = px.reshape(h, w), py.reshape(h, w)
            valid = infront.reshape(h, w) & hitm
            if have_film and raw_hist is not None and raw_hist[0].shape == color.shape:
                merged, var_m, n_eff = dn.temporal_accumulate(
                    color, variance, cnt, albedo, normal, *raw_hist, px, py, valid)
                out = self._spatial(dict(dev, color=merged, variance=var_m))
                new_raw = (merged, var_m, n_eff, albedo, normal)
            else:
                out = dn.denoise_temporal_reprojected(
                    color, albedo, normal, *prev, px, py, valid, spatial=self._spatial(dev))
        if new_raw is None and have_film:
            new_raw = (color, variance, cnt, albedo, normal)
        return out.cpu().numpy(), {"history": (out, albedo, normal), "raw": new_raw,
                                   "prev_frame": frame}

    def _stored(self, x):
        if x is None or self.storage_dtype is None:
            return x
        if isinstance(x, tuple):
            return tuple(self._stored(v) for v in x)
        return x.to(self.storage_dtype).to(x.dtype) if x.is_floating_point() else x

    @staticmethod
    def _spatial(dev: dict):
        from plainref.post.denoise import denoise_atrous, denoise_atrous_var

        if dev.get("variance") is not None:
            return denoise_atrous_var(dev["color"], dev["albedo"], dev["normal"],
                                      dev["variance"])
        return denoise_atrous(dev["color"], dev["albedo"], dev["normal"])
