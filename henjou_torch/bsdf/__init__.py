from henjou_torch.bsdf.dispatch import (
    bsdf_eval,
    bsdf_pdf,
    bsdf_sample,
    make_bsdf_sampler,
)
from henjou_torch.bsdf.disney import (
    DisneyParams,
    disney_eval,
    disney_params,
    disney_pdf,
    disney_sample,
)
from henjou_torch.bsdf.ggx import ggx_eval, ggx_pdf, ggx_sample
from henjou_torch.bsdf.glass import (
    glass_eval,
    glass_pdf,
    ideal_glass_sample,
    meta_glass_sample,
)
from henjou_torch.bsdf.lambert import lambert_eval, lambert_pdf, lambert_sample
from henjou_torch.bsdf.msggx import msggx_sample
