"""The yardstick's arithmetic: the card's peaks, and the bytes and
operations that bound a kernel or a frame.

Peaks are NVIDIA's published figures for one H100 SXM at its 700 W limit
(dense, no sparsity), as the port's `utils/profiling.H100_PEAK` states
them; a card set to a lower power limit reaches less, so every traced run
prints the card's limit beside them.
"""
from __future__ import annotations

__all__ = ["PEAK", "k1w_bytes", "k1w_bound_s", "frame_least_bytes", "frame_least_s"]

PEAK = {"flops_bf16": 989e12, "flops_f32": 67e12, "hbm_bytes_per_s": 3.35e12}


def k1w_bytes(n: int, L: int, elt: int) -> int:
    """One fused mean-field update of n rows and L labels at `elt` bytes a
    value: E0, S and C read and E and C' written once, and Mu read once."""
    return 5 * n * L * elt + L * L * elt


def k1w_bound_s(n: int, L: int, elt: int) -> float:
    """The least time of that update: the larger of its bytes at the HBM
    peak and its arithmetic (2L² a row on the tensor cores for Q'·Mu, 6L a
    row in float32 for the rest)."""
    memory = k1w_bytes(n, L, elt) / PEAK["hbm_bytes_per_s"]
    compute = 2 * L * L * n / PEAK["flops_bf16"] + 6 * L * n / PEAK["flops_f32"]
    return max(memory, compute)


def frame_least_bytes(h: int, w: int, L: int, niters: int, elt: int) -> int:
    """Bytes no implementation of one frame can avoid: each iteration reads
    and writes the (h·w, L) mean-field state once, at `elt` bytes a value,
    and the two float32 (h, w, 3) images are read once."""
    return niters * 2 * h * w * L * elt + 2 * h * w * 3 * 4


def frame_least_s(h: int, w: int, L: int, niters: int, elt: int) -> float:
    """The least time of one frame: the larger of those bytes at the HBM
    peak and 2·h·w·L² operations an iteration (the compatibility product)
    at the bf16 tensor-core peak."""
    memory = frame_least_bytes(h, w, L, niters, elt) / PEAK["hbm_bytes_per_s"]
    compute = niters * 2 * h * w * L * L / PEAK["flops_bf16"]
    return max(memory, compute)
