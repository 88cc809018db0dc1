"""Mean-field dense-CRF core: compatibilities, guides, inference."""
from .compat import charb_apply, charb_init, charbonnier, charbonnier2, potts_matrix  # noqa: F401
from .guides import ij_guide, ijrgb_guide, pixel_coords, stack_guide  # noqa: F401
from .meanfield import crf_as_rnn, mean_field_infer, mean_field_logits  # noqa: F401
