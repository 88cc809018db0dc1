"""Task models.

The JAX package's `models` re-exports flax-style init/apply pairs; the port
has `nn.Module`s in their place: `crf_rnn_*` is `CRFasRNN`, `refiner_*`
`CRFDepthRefiner`, `uncertainty_*` `CRFWithUncertainty` and `upsampler_*`
`CRFDepthUpsampler`.
"""
from .pipeline import CRFStereoConfig, calibrate_capacity, crf_stereo_infer  # noqa: F401
from .refiner import CRFasRNN, CRFDepthRefiner, CRFDepthUpsampler, CRFWithUncertainty  # noqa: F401
from .serving import StereoServer  # noqa: F401
