"""Training harness (`Trainer`, data-parallel over a mesh), metrics and
experiments."""
from .metrics import bad_pixel_ratio, epe, masked_l1, masked_mse  # noqa: F401
from .trainer import Trainer, TrainState, cosine_lr  # noqa: F401
