"""The fused mean-field update of the PyTorch port: its plain version
against the JAX package's Pallas kernel (run in interpret mode on the CPU,
as tests/test_pallas.py runs it) and the wrapper's CPU route. The CUDA
kernel itself is tested in tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_estimation_torch.ops.cuda import meanfield as T
from depth_estimation_tpu.ops.pallas import meanfield as J


def _inputs(seed, n, L):
    rs = np.random.RandomState(seed)
    return (rs.rand(n, L).astype(np.float32) * 10, rs.randn(n, L).astype(np.float32),
            rs.rand(n, L).astype(np.float32), rs.rand(L, L).astype(np.float32))


@pytest.mark.parametrize("n,L", [(2048, 16), (1024, 8), (512, 32)])
def test_plain_version_matches_pallas_interpret(n, L):
    arrays = _inputs(0, n, L)
    E_j, C_j = J.fused_energy_update(*map(jnp.asarray, arrays), block=512, interpret=True)
    E_t, C_t = T.fused_energy_update_reference(*map(torch.from_numpy, arrays))
    np.testing.assert_allclose(E_t.numpy(), np.asarray(E_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(C_t.numpy(), np.asarray(C_j), rtol=1e-5, atol=1e-6)


def test_ragged_rows_take_the_same_path():
    """The port has no block size: a ragged n computes the same rows as
    the first n rows of a larger call (the JAX wrapper falls back to its
    reference there)."""
    arrays = [torch.from_numpy(a) for a in _inputs(1, 1031, 16)]
    E_a, C_a = T.fused_energy_update(*arrays)
    E_b, C_b = T.fused_energy_update(*(a[:1000] for a in arrays[:3]), arrays[3])
    np.testing.assert_array_equal(E_b.numpy(), E_a[:1000].numpy())
    np.testing.assert_array_equal(C_b.numpy(), C_a[:1000].numpy())
    E_j, C_j = J.fused_energy_update(*(jnp.asarray(a.numpy()) for a in arrays), block=512)
    np.testing.assert_allclose(C_a.numpy(), np.asarray(C_j), rtol=1e-5, atol=1e-6)


def test_bf16_plain_version_rounds_once():
    """In bf16 the plain version computes in f32 and rounds each output
    once, as the CUDA kernel does: exactly the f32 result, rounded."""
    arrays = [torch.from_numpy(a) for a in _inputs(2, 777, 16)]
    E32, C32 = T.fused_energy_update_reference(*(a.bfloat16().float() for a in arrays))
    E, C = T.fused_energy_update_reference(*(a.bfloat16() for a in arrays))
    assert E.dtype == C.dtype == torch.bfloat16
    np.testing.assert_array_equal(E.float().numpy(), E32.bfloat16().float().numpy())
    np.testing.assert_array_equal(C.float().numpy(), C32.bfloat16().float().numpy())


def test_wrapper_refuses_other_devices():
    E0 = torch.empty(16, 16, device="meta")
    with pytest.raises(ValueError, match="device"):
        T.fused_energy_update(E0, E0, E0, torch.empty(16, 16, device="meta"))
