"""The geometry decision of a frame, made in one place: which intersector
traces it (`SceneAccel.pack`: brute force or the binned pack, cached on
the instance transforms; for animated scenes a plan, then device
refreshes), the trace functions each engine is handed (`trace_fns`,
`wavefront_trace_fns`) and the two-sample MIS light query
(`light_intersector`). `Renderer.build()` makes one per scene.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from henjou_torch.accel import pallas_binned
from henjou_torch.accel.sorting import ray_sort_key, sorted_binned_intersector
from henjou_torch.sampling.light_sample import build_light_accel, make_binned_light_intersector
from henjou_torch.scene.scenedata import DeviceScene
from henjou_torch.utils.timer import span

log = logging.getLogger("henjou_torch")

# scenes of this many triangles or fewer trace by brute force
BRUTE_FORCE_MAX_TRIS = 256
# two-sample MIS traces its light query through the binned intersector
# over the emissive subset above this many emissive triangles, densely below
BINNED_LIGHT_THRESHOLD = 512


class SceneAccel:
    def __init__(self, device_scene: DeviceScene, device: torch.device):
        self.device_scene = device_scene
        self.device = device
        # (transform bytes, accel) of the last transform set packed
        self._pack = None
        # an animated scene's planned cluster order (order on the device,
        # num_clusters, group, num_groups)
        self.plan = None
        # (transform bytes, LightAccel) of the emissive subset
        self._light = None

    def pack(self, frame_scene, xf: np.ndarray):
        """The accel of `frame_scene`, whose instance transforms are `xf`:
        None (brute force) or a binned pack, reused while `xf` is
        unchanged. The first transform set packs on the host
        (`accel.pack`); the second distinct one plans the cluster order per
        instance once (`accel.plan`), and every later new set refreshes
        the pack from that order with torch ops on the scene's device
        (`accel.refresh`)."""
        key = xf.tobytes()
        if self._pack is None or self._pack[0] != key:
            self._pack = (key, self._new_pack(frame_scene))
        return self._pack[1]

    def _new_pack(self, fs):
        ntris = int(fs.tri_verts.shape[0])
        if ntris <= BRUTE_FORCE_MAX_TRIS:
            return None
        if self.plan is None and self._pack is not None:
            with span("accel.plan"):
                offs = self.device_scene.prim_offsets.cpu().numpy()
                counts = np.diff(np.append(offs, ntris))
                order, c, group, g = pallas_binned.plan_binned_order(
                    fs.tri_verts.cpu().numpy(), list(zip(offs.tolist(), counts.tolist())))
                self.plan = (torch.from_numpy(order).to(self.device), c, group, g)
            log.info("animated scene: cluster order planned (%d clusters, group %d); "
                     "the pack refreshes on the device from here on", c, group)
        if self.plan is not None:
            with span("accel.refresh"):
                return pallas_binned.build_binned_from_order(fs.tri_verts, *self.plan)
        with span("accel.pack"):
            return pallas_binned.pack_binned_np(fs.tri_verts.cpu().numpy(), self.device)

    @staticmethod
    def trace_fns(accel):
        """(intersect_fn, occluded_fn) for an accel from `pack`: brute
        force (None, None) for None, else the binned kernel inside the
        bitonic sorted wrapper."""
        if accel is None:
            return None, None
        return sorted_binned_intersector(accel)

    @staticmethod
    def wavefront_trace_fns(accel, lanes: int):
        """(intersect_fn, occluded_fn, pool_key_fn) for the wavefront
        engine. With HENJOU_POOL_SORT=1, a binned pack and a pool of
        power-of-two lanes (a multiple of 1024): the raw binned kernels
        and the ray sort key, so the engine sorts its whole pool once per
        bounce instead of sorting and unsorting around each trace;
        otherwise `trace_fns` and no key."""
        pool_ok = lanes % 1024 == 0 and (lanes & (lanes - 1)) == 0
        if accel is not None and pool_ok and os.environ.get("HENJOU_POOL_SORT", "0") == "1":
            lo = accel.scene_lo.to(torch.float32)
            inv_extent = 1.0 / torch.clamp(accel.scene_hi.to(torch.float32) - lo, min=1e-12)
            return (*pallas_binned.make_binned_intersector(accel),
                    lambda o, d: ray_sort_key(o, d, lo, inv_extent))
        return (*SceneAccel.trace_fns(accel), None)

    def light_intersector(self, frame_scene):
        """The two-sample MIS light query for `frame_scene`: None (dense
        `intersect_lights`) up to BINNED_LIGHT_THRESHOLD emissive
        triangles, else the binned intersector over the emissive subset,
        re-packed whenever the main pack is (same transform bytes)."""
        n_lights = int(self.device_scene.num_lights)
        if n_lights <= BINNED_LIGHT_THRESHOLD:
            return None
        key = self._pack[0] if self._pack is not None else None
        if self._light is None or self._light[0] != key:
            la = build_light_accel(frame_scene.tri_verts.cpu().numpy(),
                                   self.device_scene.light_prim_ids.cpu().numpy(), self.device)
            self._light = (key, la)
            log.info("binned light intersector: %d emissive tris", n_lights)
        return make_binned_light_intersector(self._light[1])
