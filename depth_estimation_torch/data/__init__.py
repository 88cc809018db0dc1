"""Datasets and synthetic fixtures (numpy on the host)."""
from .datasets import (  # noqa: F401
    TRAIN_SCENES_2005,
    VAL_SCENES_2005,
    KITTIStereo2015,
    MiddleburyStereo2005,
    MiddleburyStereo2014,
    TsukubaPair,
    UnaryCache,
    downsize_image,
)
from .loader import (  # noqa: F401
    GroupedBatchSampler,
    aspect_ratio_groups,
    collate_detection_batch,
)
from .shapes import ShapesDetection  # noqa: F401
from .synthetic import SyntheticStereo, make_stereo_pair  # noqa: F401
