"""depth_estimation_torch — dense CRF stereo on PyTorch and CUDA (Hopper).

The PyTorch counterpart of the JAX package beside it, module for module:
cost volumes (`ops.costvolume`), the permutohedral lattice
(`ops.permutohedral`), the dense Gaussian oracle (`ops.dense_gaussian`),
mean-field CRF inference (`crf`), the flagship stereo pipeline
(`models.pipeline`) and its CLI (`apps.infer`), the training path
(`models.refiner`, `train`), batched serving (`models.serving`), the
multi-process mesh and row-striped tiling (`parallel`), and the remaining
operators (`ops.spectral`, `ops.classical`, `ops.lsh`, `models.maskdepth`).
The fused mean-field update is a hand-written CUDA kernel at every label
count (`csrc/meanfield.cu` at 8 to 64 labels, `csrc/meanfield_wide.cu` at
any other, bound in `ops.cuda.meanfield`); `utils.native` binds the C++ CPU
lattice; everything else is PyTorch tensor code.

Entry points run on the GPU (`device=None` means "cuda") and raise when
no GPU is present; pass `device="cpu"` to run the plain PyTorch versions.
"""

__version__ = "0.1.0"
