"""BSDF facade: per-hit lobe dispatch (port of henjou_tpu/bsdf/dispatch.py).

Routing:
- ideal_specular        -> MetaMaterialGlass
- else metallic > 0.5   -> multiple-scattering GGX
- else                  -> Disney
eval/pdf route to glass-or-Disney only.

The plain version (`sample_plain`, `eval_plain`, `pdf_plain`, the CPU
path) computes each lobe's sample on every lane from the same input
sampler state; outputs and the advanced sampler state are then selected by
category, so each lane's random stream advances exactly as if only its
branch had run. The has_* flags are scene facts: lobes no material uses
are skipped.

On CUDA inputs each of `bsdf_sample`, `bsdf_eval` and `bsdf_pdf` is one
launch of ``csrc/bsdf.cu``, where each lane runs only its own lobe, with
its draws inside: the same bits as the plain version on the same device.
The hit's fields, the directions and the state's fields must share one
lane shape and one device (float32 values, bool flags, int64 state);
non-contiguous ones are copied. ``LAUNCHES`` counts the calls that went
through a kernel's entry point (a call of no lanes launches nothing);
under a profiler session the counters ``bsdf.calls`` and
``bsdf.calls_kernel`` count every call and those through the kernels.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from henjou_torch.bsdf.disney import DisneyParams, disney_eval, disney_params, disney_pdf, disney_sample
from henjou_torch.bsdf.glass import glass_eval, glass_pdf, meta_glass_sample
from henjou_torch.bsdf.msggx import msggx_sample
from henjou_torch.csrc import INT, PTR, bind, check
from henjou_torch.sampling.cmj import CMJState
from henjou_torch.utils.timer import count

LAUNCHES = 0
# csrc/bsdf.cuh kHas*, kSobol
_HAS_SPECULAR, _HAS_METAL, _HAS_SHEEN, _HAS_CLEARCOAT, _SOBOL = 1, 2, 4, 8, 16


def _params_from_hit(hit) -> DisneyParams:
    return disney_params(
        basecolor=hit.basecolor,
        roughness=hit.roughness,
        metallic=hit.metallic,
        sheen=hit.sheen,
        clearcoat=hit.clearcoat,
        is_thinfilm=hit.is_thinfilm,
    )


def _sel_state(mask, a: CMJState, b: CMJState) -> CMJState:
    return b._replace(depth=torch.where(mask, a.depth, b.depth))


def sample_plain(hit, local_wo, state: CMJState, lut: Optional[torch.Tensor] = None,
                 has_specular: bool = True, has_metal: bool = True,
                 has_sheen: bool = True, has_clearcoat: bool = True):
    """The torch code of `bsdf_sample`, on any device."""
    p = _params_from_hit(hit)
    bsdf, wi, pdf, st = disney_sample(p, local_wo, state, lut, has_sheen, has_clearcoat)

    if has_metal:
        is_ggx = hit.metallic > 0.5
        b_ms, wi_ms, pdf_ms, st_ms = msggx_sample(hit.basecolor, hit.roughness, local_wo, state)
        ggx = is_ggx[..., None]
        bsdf = torch.where(ggx, b_ms, bsdf)
        wi = torch.where(ggx, wi_ms, wi)
        pdf = torch.where(is_ggx, pdf_ms, pdf)
        st = _sel_state(is_ggx, st_ms, st)

    if has_specular:
        is_spec = hit.is_specular
        b_glass, wi_glass, pdf_glass, st_glass = meta_glass_sample(
            torch.ones_like(hit.basecolor), hit.ior, local_wo, state
        )
        spec = is_spec[..., None]
        bsdf = torch.where(spec, b_glass, bsdf)
        wi = torch.where(spec, wi_glass, wi)
        pdf = torch.where(is_spec, pdf_glass, pdf)
        st = _sel_state(is_spec, st_glass, st)

    return bsdf, wi, pdf, st


def eval_plain(hit, local_wo, local_wi, lut: Optional[torch.Tensor] = None,
               has_sheen: bool = True, has_clearcoat: bool = True):
    """The torch code of `bsdf_eval`, on any device."""
    p = _params_from_hit(hit)
    val = disney_eval(p, local_wo, local_wi, lut, has_sheen, has_clearcoat)
    return torch.where(hit.is_specular[..., None], glass_eval(local_wo, local_wi), val)


def pdf_plain(hit, local_wo, local_wi):
    """The torch code of `bsdf_pdf`, on any device."""
    p = _params_from_hit(hit)
    val = disney_pdf(p, local_wo, local_wi)
    return torch.where(hit.is_specular, glass_pdf(local_wo, local_wi), val)


def kernel_inputs(shape, device, fields):
    """Each (name, tensor, dtype, trailing dims) of `fields` as a contiguous
    tensor of shape ``(*shape, *trailing)`` on `device` (a copy where it is
    strided; the copy lives until the launch is queued, and torch's
    allocator reuses its memory only after that launch on the stream).
    Raises ValueError for another dtype, shape or device: the kernels read
    raw memory and convert nothing."""
    out = []
    for name, x, dtype, trailing in fields:
        want = (*shape, *trailing)
        if x.dtype != dtype or tuple(x.shape) != want or x.device != device:
            raise ValueError(f"{name} must be {dtype} of shape {want} on {device}, got "
                             f"{x.dtype} of shape {tuple(x.shape)} on {x.device}")
        out.append(x.contiguous())
    return out


def _hit_fields(hit, names):
    kinds = {"basecolor": (torch.float32, (3,)), "is_thinfilm": (torch.bool, ()),
             "is_specular": (torch.bool, ())}
    return [(f"hit.{n}", getattr(hit, n), *kinds.get(n, (torch.float32, ()))) for n in names]


def _state_fields(state: CMJState):
    return [(f"state.{n}", getattr(state, n), torch.int64, ()) for n in CMJState._fields[:4]]


def _lut_args(lut, device):
    if lut is None:
        return [None, 0, 0]
    if lut.dtype != torch.float32 or lut.dim() != 3 or lut.shape[2] != 3 or lut.device != device:
        raise ValueError(f"lut must be float32 [H, W, 3] on {device}, got {lut.dtype} of shape "
                         f"{tuple(lut.shape)} on {lut.device}")
    lut = lut.contiguous()
    return [lut, lut.shape[0], lut.shape[1]]


# the C entry points' arguments: the hit's fields, the directions and the
# state's fields; the lane count and the flags (and the LUT); the outputs;
# the stream
_ARGTYPES = {
    "henjou_bsdf_sample": [PTR] * 13 + [INT, INT, PTR, INT, INT] + [PTR] * 4 + [PTR],
    "henjou_bsdf_eval": [PTR] * 9 + [INT, INT, PTR, INT, INT] + [PTR] + [PTR],
    "henjou_bsdf_pdf": [PTR] * 5 + [INT] + [PTR] + [PTR],
}


@functools.cache
def _kernel_fn(name: str):
    return bind(name, _ARGTYPES[name])


def _launch(name: str, device, args) -> None:
    """One call of csrc/bsdf.cu's entry point `name` on `device`'s current
    stream; tensors go as their data pointers, None as a null pointer."""
    global LAUNCHES
    err = _kernel_fn(name)(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
                           torch.cuda.current_stream(device).cuda_stream)
    check(err, name)
    LAUNCHES += 1
    count("bsdf.calls_kernel", 1)


def bsdf_sample(hit, local_wo, state: CMJState, lut: Optional[torch.Tensor] = None,
                has_specular: bool = True, has_metal: bool = True,
                has_sheen: bool = True, has_clearcoat: bool = True):
    """Returns (bsdf[R,3], wi[R,3], pdf[R], state): on CUDA one launch of
    csrc/bsdf.cu, elsewhere `sample_plain`. Only the state's `depth`
    changes."""
    count("bsdf.calls", 1)
    if not local_wo.is_cuda:
        return sample_plain(hit, local_wo, state, lut, has_specular, has_metal, has_sheen,
                            has_clearcoat)
    shape, dev = local_wo.shape[:-1], local_wo.device
    ins = kernel_inputs(shape, dev, _hit_fields(hit, (
        "basecolor", "roughness", "metallic", "sheen", "clearcoat", "is_thinfilm", "is_specular",
        "ior")) + [("local_wo", local_wo, torch.float32, (3,))] + _state_fields(state))
    flags = (_HAS_SPECULAR * has_specular + _HAS_METAL * has_metal + _HAS_SHEEN * has_sheen
             + _HAS_CLEARCOAT * has_clearcoat + _SOBOL * state.sobol)
    bsdf = torch.empty((*shape, 3), dtype=torch.float32, device=dev)
    wi = torch.empty((*shape, 3), dtype=torch.float32, device=dev)
    pdf = torch.empty(shape, dtype=torch.float32, device=dev)
    depth = torch.empty(shape, dtype=torch.int64, device=dev)
    _launch("henjou_bsdf_sample", dev, [*ins, shape.numel(), flags, *_lut_args(lut, dev),
                                        bsdf, wi, pdf, depth])
    return bsdf, wi, pdf, state._replace(depth=depth)


def bsdf_eval(hit, local_wo, local_wi, lut: Optional[torch.Tensor] = None,
              has_sheen: bool = True, has_clearcoat: bool = True):
    """Glass lanes are delta (0); everything else evaluates Disney,
    metals included, as the reference does for NEE. On CUDA one launch of
    csrc/bsdf.cu, elsewhere `eval_plain`."""
    count("bsdf.calls", 1)
    if not local_wo.is_cuda:
        return eval_plain(hit, local_wo, local_wi, lut, has_sheen, has_clearcoat)
    shape, dev = local_wo.shape[:-1], local_wo.device
    ins = kernel_inputs(shape, dev, _hit_fields(hit, (
        "basecolor", "roughness", "metallic", "sheen", "clearcoat", "is_thinfilm",
        "is_specular")) + [("local_wo", local_wo, torch.float32, (3,)),
                           ("local_wi", local_wi, torch.float32, (3,))])
    out = torch.empty((*shape, 3), dtype=torch.float32, device=dev)
    flags = _HAS_SHEEN * has_sheen + _HAS_CLEARCOAT * has_clearcoat
    _launch("henjou_bsdf_eval", dev, [*ins, shape.numel(), flags, *_lut_args(lut, dev), out])
    return out


def bsdf_pdf(hit, local_wo, local_wi):
    """The MIS pdf: glass lanes 0, everything else the Disney mixture. On
    CUDA one launch of csrc/bsdf.cu, elsewhere `pdf_plain`."""
    count("bsdf.calls", 1)
    if not local_wo.is_cuda:
        return pdf_plain(hit, local_wo, local_wi)
    shape, dev = local_wo.shape[:-1], local_wo.device
    ins = kernel_inputs(shape, dev, _hit_fields(hit, ("roughness", "metallic", "is_specular"))
                        + [("local_wo", local_wo, torch.float32, (3,)),
                           ("local_wi", local_wi, torch.float32, (3,))])
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    _launch("henjou_bsdf_pdf", dev, [*ins, shape.numel(), out])
    return out


def make_bsdf_sampler(lut: Optional[torch.Tensor] = None, has_specular: bool = True,
                      has_metal: bool = True, has_sheen: bool = True,
                      has_clearcoat: bool = True):
    """Closure matching the integrator's bsdf_sample signature."""

    def sampler(hit, local_wo, state):
        return bsdf_sample(
            hit, local_wo, state, lut,
            has_specular=has_specular, has_metal=has_metal,
            has_sheen=has_sheen, has_clearcoat=has_clearcoat,
        )

    return sampler
