"""The stereo cost volume on the card: one launch of the hand-written kernel
of `csrc/costvolume.cu`.

`cost_volume_kernel` computes what `ops.costvolume.cost_volume_reference`
computes for the absolute-difference criterion and `agg_mode="reflect"`,
times `scale`: the (h, w, L) float32 window sums of Σ_ch |left − right
shifted by d|, read from the images and written once, with no intermediate
volume in device memory. Its sums are f32 sums in one fixed order
(channels, the window's rows, its columns, then the scale), so it is
deterministic; they are not the plain version's cumsum differences, and
round less. It replaces no Pallas kernel: the JAX package leaves the cost
volume to XLA.

The kernel's side chooses the launch (`costvolume_geometry` reads it) and
refuses what it does not take: 1 or 3 channels and odd windows up to 17
are built. The wrapper counts its launches (`cost_volume_kernel.launches`).
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["cost_volume_kernel", "costvolume_geometry"]

# what the kernel's side refuses, by its code
_REFUSED = {-1: "1 or 3 channels", -2: "an odd window from 1 to 17",
            -3: "a non-empty frame of at most 65535 tiles a side"}


def _lib():
    from ...utils.build import load_library

    lib = load_library("costvolume")
    lib.costvolume_launch.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                                      + [ctypes.c_float, ctypes.c_void_p])
    lib.costvolume_geometry.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    lib.costvolume_launch.restype = lib.costvolume_geometry.restype = ctypes.c_int
    return lib


def _refusal(code: int, shape, num_disp: int, window_size: int) -> ValueError:
    return ValueError(f"cost_volume_kernel: takes {_REFUSED[code]}, got images of shape "
                      f"{tuple(shape)}, num_disp={num_disp}, window_size={window_size}")


def costvolume_geometry(h: int, w: int, c: int, L: int, window_size: int) -> dict:
    """The launch the kernel makes for an (h, w, c) frame, L labels and an
    odd window: labels a block, the tile's output columns, the strip's
    output rows and the block's shared memory in bytes. Raises what the
    kernel refuses."""
    geom = (ctypes.c_int * 4)()
    err = _lib().costvolume_geometry(h, w, c, L, window_size // 2, geom)
    if err:
        raise _refusal(err, (h, w, c), L, window_size)
    return dict(zip(("labels", "tile_w", "strip", "smem"), geom))


def cost_volume_kernel(left: torch.Tensor, right: torch.Tensor, num_disp: int,
                       window_size: int = 9, scale: float = 1.0) -> torch.Tensor:
    """The kernel: `scale` × the (h, w, num_disp) aggregated absolute
    difference cost of contiguous float32 (h, w, c) CUDA images, windows
    of `window_size` (odd) with the symmetric border. Raises on what the
    kernel does not take."""
    if not (left.device.type == "cuda" and right.device == left.device
            and left.dtype == right.dtype == torch.float32 and left.dim() == 3
            and right.shape == left.shape and num_disp >= 1 and window_size % 2 == 1):
        raise ValueError(f"cost_volume_kernel: wants float32 (h, w, c) CUDA images of one "
                         f"shape, num_disp >= 1 and an odd window, got "
                         f"{tuple(left.shape)} {left.dtype} on {left.device}, "
                         f"{tuple(right.shape)} {right.dtype} on {right.device}, "
                         f"num_disp={num_disp}, window_size={window_size}")
    if not (left.is_contiguous() and right.is_contiguous()):
        raise ValueError("cost_volume_kernel: wants contiguous images")
    h, w, c = left.shape
    out = torch.empty(h, w, num_disp, dtype=torch.float32, device=left.device)
    with torch.cuda.device(left.device):
        err = _lib().costvolume_launch(left.data_ptr(), right.data_ptr(), out.data_ptr(), h, w,
                                       c, num_disp, window_size // 2, float(scale),
                                       torch.cuda.current_stream().cuda_stream)
    if err < 0:
        raise _refusal(err, left.shape, num_disp, window_size)
    if err:
        raise RuntimeError(f"cost_volume_kernel launch failed: cudaError {err}")
    cost_volume_kernel.launches += 1
    return out


cost_volume_kernel.launches = 0  # the kernel's launches, for run-time path checks
