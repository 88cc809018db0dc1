"""The PyTorch port's CUDA kernels against their plain versions, on a card.

These tests import neither JAX nor the JAX package, so a GPU machine without
JAX runs them, skipping the JAX-specific conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Without a CUDA device every test skips (a kernel has no CPU mode)."""
import numpy as np
import pytest
import torch

from depth_estimation_torch.ops.cuda import meanfield as T


def _inputs(seed, n, L):
    rs = np.random.RandomState(seed)
    return (rs.rand(n, L).astype(np.float32) * 10, rs.randn(n, L).astype(np.float32),
            rs.rand(n, L).astype(np.float32), rs.rand(L, L).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,L", [(110592, 16), (110585, 16), (4099, 8), (1000, 32),
                                 (300, 64)])
def test_cuda_kernel_matches_plain_version(n, L, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    arrays = [torch.from_numpy(a).to("cuda", dtype) for a in _inputs(3, n, L)]
    before = T.fused_energy_update.launches
    E_k, C_k = T.fused_energy_update(*arrays)
    torch.cuda.synchronize()
    assert T.fused_energy_update.launches == before + 1
    E_r, C_r = T.fused_energy_update_reference(*arrays)
    if dtype == torch.float32:
        torch.testing.assert_close(E_k, E_r, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(C_k, C_r, rtol=1e-5, atol=1e-5)
    else:
        ulp = 2.0 ** (torch.floor(torch.log2(E_r.float().abs().clamp_min(1e-30))) - 7)
        assert bool(((E_k.float() - E_r.float()).abs() <= ulp).all())
        torch.testing.assert_close(C_k.float(), C_r.float(), rtol=0, atol=1e-2)
