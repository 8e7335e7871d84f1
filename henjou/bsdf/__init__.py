from henjou.bsdf.dispatch import (
    bsdf_eval,
    bsdf_pdf,
    bsdf_sample,
    make_bsdf_sampler,
)
from henjou.bsdf.disney import (
    DisneyParams,
    disney_eval,
    disney_params,
    disney_pdf,
    disney_sample,
)
from henjou.bsdf.ggx import ggx_eval, ggx_pdf, ggx_sample
from henjou.bsdf.glass import (
    glass_eval,
    glass_pdf,
    ideal_glass_sample,
    meta_glass_sample,
)
from henjou.bsdf.lambert import lambert_eval, lambert_pdf, lambert_sample
from henjou.bsdf.msggx import msggx_sample
