"""The fused mean-field update above 1024 labels (K1xx): its launch geometry
and routing, its arithmetic emulated in plain torch (bf16: an online
softmax over chunks of 32 labels, its sums rescaled where a chunk's max
grows, q's terms as three bf16 values against Mu in k-steps of 16 labels;
f32: PyTorch's warp-softmax order, max and sum in two walks, and one
in-order FMA chain over the labels) against the plain version, the plain version against the JAX
package's Pallas kernel (interpret mode) at 1100 labels, and the wrapper's
refusals. The kernel itself is held against the plain version on a card by
tests/test_torch_cuda.py and by chip_smoke.py's phase M."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_estimation_torch.ops.cuda import meanfield as T
from depth_estimation_tpu.ops.pallas import meanfield as J

MAX_DYNAMIC_SMEM = 232448  # what an H100 block may opt into (227 KB)
SMS = 132  # the H100's SMs
N = 393216  # rows of a 512x768 frame


def _inputs(seed, n, L):
    rs = np.random.RandomState(seed)
    return (rs.rand(n, L).astype(np.float32) * 10, rs.randn(n, L).astype(np.float32),
            rs.rand(n, L).astype(np.float32), rs.rand(L, L).astype(np.float32))


# (LP, passes) of K1xx at each L
XXWIDE = {1025: (1056, 3), 1536: (1536, 3), 4099: (4128, 9), 54012: (54016, 106)}


@pytest.mark.parametrize("elt", [2, 4])
@pytest.mark.parametrize("L", sorted(XXWIDE))
def test_xxwide_geometry(L, elt):
    """LP is L padded to 32 labels (a stage's chunk); a pass is 512 output
    columns (in bf16 two warpgroups' 256, wgmma's widest N); a tile has 64
    rows in bf16 (one m64 row block) and a work item is a (tile, pass)
    pair, in f32 32 rows and all their passes; one persistent block a SM of
    4 producer and 8 consumer warps; the shared memory (the ring's stages of
    a q chunk and a Mu tile, bf16's row factors or f32's row statistics,
    the mbarriers) is the same at every L and fits a block."""
    g = T.xxwide_geometry(N, L, elt, SMS)
    lp, passes = XXWIDE[L]
    assert (g.lp, g.passes) == (lp, passes)
    assert g.lp % 32 == 0 and g.lp - 32 < L <= g.lp
    assert g.pass_cols == 512
    assert g.mu_cols == 512 * passes and g.mu_cols - 512 < L <= g.mu_cols
    assert g.rows == (64 if elt == 2 else 32) and g.threads == 384
    assert g.num_tiles == -(-N // g.rows)
    assert g.num_items == g.num_tiles * (passes if elt == 2 else 1) and g.grid == SMS
    if elt == 2:
        want = 5 * (3 * 64 * 32 * 2 + 32 * 512 * 2 + 640) + 10 * 8
    else:
        want = 3 * (32 * 36 * 4 + 32 * 512 * 4) + 2 * 32 * 8 + 6 * 8
    assert g.smem_bytes == T.xxwide_smem_bytes(elt) == want <= MAX_DYNAMIC_SMEM
    assert g.smem_bytes == {2: 228560, 4: 210992}[elt]


def test_xxwide_geometry_at_its_limits():
    """A few rows launch one block; any L ≥ 1 has a geometry; no rows or no
    labels are refused."""
    g = T.xxwide_geometry(5, 1100, 2, SMS)
    assert (g.num_tiles, g.num_items, g.grid, g.lp, g.passes) == (1, 3, 3, 1120, 3)
    g = T.xxwide_geometry(5, 1100, 4, SMS)
    assert (g.num_tiles, g.num_items, g.grid, g.passes) == (1, 1, 1, 3)
    assert T.xxwide_geometry(1, 10**6, 4, SMS).passes == 1954
    with pytest.raises(ValueError, match="at least one row"):
        T.xxwide_geometry(0, 1100, 2, SMS)
    with pytest.raises(ValueError, match="at least one label"):
        T.xxwide_geometry(1, 0, 2, SMS)


@pytest.mark.parametrize("L,want", [(1024, "K1x"), (1025, "K1xx"), (54012, "K1xx"),
                                    (10**6, "K1xx")])
def test_kernel_for_sends_every_l_above_xwide_max_l_to_k1xx(L, want):
    """Every label count above XWIDE_MAX_L goes to K1xx, with no upper
    limit."""
    assert T.kernel_for(L) == want
    assert T.kernel_for(T.XWIDE_MAX_L + 1) == "K1xx"


def _split(q, terms):
    """q as `terms` bf16 values, each the rounding of what the ones before
    it leave (as f32)."""
    out, rest = [], q
    for _ in range(terms):
        out.append(rest.to(torch.bfloat16).float())
        rest = rest - out[-1]
    return out


LOG2E = 1.4426950408889634


def _xxwide_bf16(E0, S, C, Mu, terms=3, rounded=True):
    """K1xx's bf16 arithmetic in plain torch (FlashAttention's online
    softmax): E in f32, x = -E; the row walked in chunks of 32 labels, its
    reference max m the first chunk's max, raised to a later chunk's max
    where that exceeds it by more than 8 log2 units, the running sum and
    C' accumulator then scaled by exp(m_old - m_new); a chunk's terms p =
    2^((x - m) log2(e)) split into `terms` bf16 values (smallest first)
    against Mu in k-steps of 16 labels (products exact in f32 since Mu is
    bf16, summed in f32); C' = accumulator / sum, rounded once to bf16
    (`rounded`)."""
    n, L = E0.shape
    E = E0.float() + (S.float() - C.float())
    lp = -(-L // 32) * 32
    x = torch.full((n, lp), -torch.inf)
    x[:, :L] = -E
    mu = torch.zeros(lp, L)
    mu[:L] = Mu.float()
    acc, total, m = torch.zeros(n, L), torch.zeros(n, 1), None
    for k0 in range(0, lp, 32):
        xk = x[:, k0:k0 + 32]
        cm = xk.max(dim=1, keepdim=True).values
        if m is None:
            m = cm
        else:
            grow = (cm - m) * LOG2E > 8
            f = torch.where(grow, torch.exp2((m - cm) * LOG2E), 1.0)
            acc, total, m = acc * f, total * f, torch.where(grow, cm, m)
        p = torch.exp2((xk - m) * LOG2E)
        total = total + p.sum(dim=1, keepdim=True)
        for kk in (0, 16):
            for part in _split(p[:, kk:kk + 16], terms)[::-1]:
                acc = acc + part @ mu[k0 + kk:k0 + kk + 16]
    Cn = acc * (1.0 / total)
    return E.to(torch.bfloat16), Cn.to(torch.bfloat16) if rounded else Cn


def _xxwide_f32(E0, S, C, Mu):
    """K1xx's f32 arithmetic in plain torch, the plain version's on the card
    up to 2048 labels (PyTorch's warp softmax): the max over the row, then
    lane j of 32 sums exp(x - max) over labels j, j + 32, ... in order, the
    lanes' sums reduced by xor 16, 8, 4, 2, 1; q = exp / sum; C' summed over
    l in order from 0 by fused multiply-adds (each exact in float64, rounded
    to f32)."""
    n, L = E0.shape
    E = E0 + (S - C)
    iters = -(-L // 32)
    x = torch.full((n, 32 * iters), -torch.inf)
    x[:, :L] = -E
    e = torch.exp(x - x.max(dim=1, keepdim=True).values)
    part = torch.zeros(n, 32)
    for it in range(iters):
        part = part + e[:, 32 * it:32 * it + 32]
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        part = part + part[:, lanes ^ o]
    q = e[:, :L] / part[:, :1]
    acc = torch.zeros(n, L, dtype=torch.float64)
    mu = Mu.double()
    for l in range(L):
        acc = (q[:, l:l + 1].double() * mu[l] + acc).float().double()
    return E, acc.float()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xxwide_arithmetic_matches_plain_version(dtype):
    """K1xx's arithmetic at 1100 labels stays within chip_smoke.py's gates:
    in bf16 one bf16 ulp on E (E exact) and 1e-2 on C', moving few C'
    values off the plain version's rounding (three terms of q move fewer
    than two); in f32 F32_TOL, with E exact."""
    dtype = getattr(torch, dtype)
    n = 256 if dtype == torch.bfloat16 else 64
    args = [torch.from_numpy(a).to(dtype) for a in _inputs(30, n, 1100)]
    E_r, C_r = T.fused_energy_update_reference(*args)
    if dtype == torch.bfloat16:
        E_k, C_k = _xxwide_bf16(*args)
        assert torch.equal(E_k, E_r)
        torch.testing.assert_close(C_k.float(), C_r.float(), rtol=0, atol=1e-2)
        three = float((C_k != C_r).float().mean())
        two = float((_xxwide_bf16(*args, terms=2)[1] != C_r).float().mean())
        assert three < 1e-3 and three <= two
    else:
        E_k, C_k = _xxwide_f32(*args)
        assert torch.equal(E_k, E_r)
        torch.testing.assert_close(C_k, C_r, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_online_softmax_rescales_to_the_softmax(where):
    """The bf16 path's online softmax gives the row's softmax to f32
    rounding (Mu the identity, before C' is rounded), where the row's max
    lies in the first chunk, or 30 log2 units above the first chunk's in a
    middle or the last chunk (so the sums are rescaled)."""
    L = 1100
    rs = np.random.RandomState(31)
    x = rs.randn(4, L).astype(np.float32)
    at = {"first": 3, "middle": L // 2, "last": L - 1}[where]
    x[:, at] = 9.0 if where == "first" else 30.0 / LOG2E
    E0 = torch.from_numpy(-x)
    zero = torch.zeros_like(E0)
    _, Cn = _xxwide_bf16(E0, zero, zero, torch.eye(L), rounded=False)
    torch.testing.assert_close(Cn, torch.softmax(torch.from_numpy(x), dim=-1), rtol=1e-5,
                               atol=1e-9)


def test_plain_version_matches_pallas_interpret_above_1024():
    arrays = _inputs(32, 1024, 1100)
    E_j, C_j = J.fused_energy_update(*map(jnp.asarray, arrays), block=256, interpret=True)
    E_t, C_t = T.fused_energy_update_reference(*map(torch.from_numpy, arrays))
    np.testing.assert_allclose(E_t.numpy(), np.asarray(E_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(C_t.numpy(), np.asarray(C_j), rtol=1e-5, atol=1e-5)


def test_xxwide_wrapper_refuses_other_devices_and_dtypes():
    meta = torch.empty(16, 1100, device="meta")
    with pytest.raises(ValueError, match="device"):
        T.fused_energy_update_xxwide(meta, meta, meta, torch.empty(1100, 1100, device="meta"))
    for dtype in (torch.float16, torch.float64):
        e = torch.empty(16, 1100, dtype=dtype, device="meta")
        with pytest.raises(ValueError, match="dtype"):
            T.fused_energy_update_xxwide(e, e, e,
                                         torch.empty(1100, 1100, dtype=dtype, device="meta"))
