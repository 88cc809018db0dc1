"""The PyTorch port's differentiable lattice against the JAX package on the
CPU: ∂src and ∂ref of `lattice_filter_planned` equal `jax.grad` through
the JAX custom VJP on the same guide (1e-4 of the largest |gradient|), the
transpose is exact in f64, `gradcheck` passes on src, ∂ref follows the
dense Gaussian's autodiff as closely as the JAX package's does, and the
wrappers, dense oracles, compatibility, guides and `crf_as_rnn` agree."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_estimation_torch.crf import compat as Tc
from depth_estimation_torch.crf import guides as Tg
from depth_estimation_torch.crf import meanfield as Tm
from depth_estimation_torch.ops import dense_gaussian as Td
from depth_estimation_torch.ops import permutohedral as T
from depth_estimation_torch.utils.weights import params_from_jax
from depth_estimation_tpu.crf import compat as Jc
from depth_estimation_tpu.crf import guides as Jg
from depth_estimation_tpu.crf import meanfield as Jm
from depth_estimation_tpu.ops import dense_gaussian as Jd
from depth_estimation_tpu.ops import permutohedral as J

GRAD_RTOL = 1e-4  # of the largest |gradient|

# (kind, plan kwargs): untiled, general plan with tiled f32 tables, lean tiled f32
PLANS = {
    "untiled": dict(max_vertices=2048),
    "tiled": dict(max_vertices=2048, tile=64, tile_u=320),
    "lean": dict(max_vertices=2048, tile=64, tile_u=320, sort_mode="packed1",
                 order_by_sum=False),
}


def _arrays(seed, n=512, d=4, L=3, scale=1.2):
    rs = np.random.RandomState(seed)
    return ((rs.randn(n, d) * scale).astype(np.float32), rs.rand(n, L).astype(np.float32),
            rs.randn(n, L).astype(np.float32))


def _close(a, b, rtol=GRAD_RTOL):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * np.abs(b).max())


def _port_grads(ref, src, g, plan_kw):
    rt = torch.from_numpy(ref).requires_grad_()
    st = torch.from_numpy(src).requires_grad_()
    plan = T.build_plan(rt.detach(), **plan_kw)
    out = T.lattice_filter_planned(st, rt, plan)
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), st.grad.numpy(), rt.grad.numpy(), plan


@pytest.mark.parametrize("kind", list(PLANS))
def test_grads_match_jax(kind):
    ref, src, g = _arrays(0)
    kw = PLANS[kind]
    pj = jax.jit(partial(J.build_plan, **kw))(jnp.asarray(ref))

    @jax.jit
    def jgrad(s, r):
        def loss(s, r):
            out = J.lattice_filter_planned(s, r, pj)
            return jnp.vdot(jnp.asarray(g), out), out
        return jax.grad(loss, argnums=(0, 1), has_aux=True)(s, r)

    (gs_j, gr_j), out_j = jgrad(jnp.asarray(src), jnp.asarray(ref))
    out_t, gs_t, gr_t, plan = _port_grads(ref, src, g, kw)
    assert (plan.slot is None) == (kind == "lean")
    _close(out_t, out_j)
    _close(gs_t, gs_j)
    _close(gr_t, gr_j)


def test_ref_grad_is_the_four_filter_formula_and_the_plan_gets_none():
    """∂ref comes only from the Function: it equals the 4-filter identity
    written out by hand, and no plan table requires or receives grad."""
    ref, src, g = _arrays(1, n=256, d=3, L=2)
    _, gs_t, gr_t, plan = _port_grads(ref, src, g, PLANS["tiled"])
    for t in plan:
        assert t is None or (not t.requires_grad and t.grad is None)
    r, s, gg = (torch.from_numpy(x) for x in (ref, src, g))
    W = lambda x: T.apply_plan(plan, x)  # noqa: E731
    want = -(s[..., None] * r[:, None] * W(gg)[..., None]
             - s[..., None] * torch.stack([W(gg * r[:, k:k + 1]) for k in range(3)], -1)
             + gg[..., None] * r[:, None] * W(s)[..., None]
             - gg[..., None] * torch.stack([W(s * r[:, k:k + 1]) for k in range(3)], -1)).sum(1)
    _close(gr_t, want.numpy(), rtol=1e-5)
    _close(gs_t, T.apply_plan(plan, gg, reverse=True).numpy(), rtol=1e-6)


@pytest.mark.parametrize("kind", ["untiled", "tiled"])
def test_transpose_is_exact_in_f64(kind):
    ref, src, g = (x.astype(np.float64) for x in _arrays(2, n=256, d=3, L=2))
    plan = T.build_plan(torch.from_numpy(ref), **PLANS[kind])
    s, gg = torch.from_numpy(src), torch.from_numpy(g)
    lhs = float((gg * T.apply_plan(plan, s)).sum())
    rhs = float((T.apply_plan(plan, gg, reverse=True) * s).sum())
    np.testing.assert_allclose(lhs, rhs, rtol=1e-10)


def test_gradcheck_on_src_in_f64():
    ref, src, _ = (x.astype(np.float64) for x in _arrays(3, n=60, d=2, L=2))
    r = torch.from_numpy(ref)
    plan = T.build_plan(r)
    s = torch.from_numpy(src).requires_grad_()
    assert torch.autograd.gradcheck(lambda x: T.lattice_filter_planned(x, r, plan), (s,))


def test_grad_ref_against_dense_autodiff():
    """The 4-filter identity is the dense Gaussian's derivative, not the
    discretised lattice's: the JAX package's own bound (correlation over
    0.97, scale within (0.5, 1.5)) on the JAX test's inputs."""
    rng = np.random.RandomState(3)
    n, d, L = 120, 2, 2
    ref = rng.randn(n, d) * 1.2
    src = rng.rand(n, L)
    g = rng.randn(n, L)
    r_lat = torch.tensor(ref, requires_grad=True)
    (torch.from_numpy(g) * T.lattice_filter(torch.from_numpy(src), r_lat)).sum().backward()
    r_den = torch.tensor(ref, requires_grad=True)
    (torch.from_numpy(g) * Td.dense_gaussian_filter(torch.from_numpy(src), r_den, block=64)
     ).sum().backward()
    grad_lat, grad_dense = r_lat.grad.numpy(), r_den.grad.numpy()
    corr = np.corrcoef(grad_dense.ravel(), grad_lat.ravel())[0, 1]
    scale = (grad_lat * grad_dense).sum() / (grad_dense ** 2).sum()
    assert corr > 0.97 and 0.5 < scale < 1.5, (corr, scale)


@pytest.mark.parametrize("normalize,k", [("none", 1), ("homogeneous", 2)])
def test_lattice_filter_matches_jax(normalize, k):
    ref, src, g = _arrays(4, n=300, d=3, L=2, scale=1.5)

    @jax.jit
    def jrun(s, r):
        def loss(s, r):
            out = J.lattice_filter(s, r, normalize=normalize, num_lattices=k, max_vertices=4096)
            return jnp.vdot(jnp.asarray(g), out), out
        return jax.grad(loss, argnums=(0, 1), has_aux=True)(s, r)

    (gs_j, gr_j), out_j = jrun(jnp.asarray(src), jnp.asarray(ref))
    st = torch.from_numpy(src).requires_grad_()
    rt = torch.from_numpy(ref).requires_grad_()
    out = T.lattice_filter(st, rt, normalize=normalize, num_lattices=k, max_vertices=4096)
    (out * torch.from_numpy(g)).sum().backward()
    _close(out.detach().numpy(), out_j)
    _close(st.grad.numpy(), gs_j)
    _close(rt.grad.numpy(), gr_j)


def test_adjacency_and_batched_forms_match_jax():
    rs = np.random.RandomState(5)
    imgs = rs.rand(2, 12, 16, 3).astype(np.float32)
    guides = (rs.randn(2, 12, 16, 3) * 1.5).astype(np.float32)
    want = np.asarray(jax.jit(J.batched_lattice_adjacency)(jnp.asarray(imgs), jnp.asarray(guides)))
    got = T.batched_lattice_adjacency(torch.from_numpy(imgs), torch.from_numpy(guides)).numpy()
    _close(got, want)
    flat_s, flat_r = imgs.reshape(2, -1, 3), guides.reshape(2, -1, 3)
    want = np.asarray(jax.jit(partial(J.lattice_filter_batched, normalize="homogeneous"))(
        jnp.asarray(flat_s), jnp.asarray(flat_r)))
    got = T.lattice_filter_batched(torch.from_numpy(flat_s), torch.from_numpy(flat_r),
                                   normalize="homogeneous").numpy()
    _close(got, want)
    want = np.asarray(jax.jit(J.lattice_adjacency)(jnp.asarray(flat_s[0]), jnp.asarray(flat_r[0])))
    got = T.lattice_adjacency(torch.from_numpy(flat_s[0]), torch.from_numpy(flat_r[0])).numpy()
    _close(got, want)


def test_dense_oracles_match_jax():
    rs = np.random.RandomState(6)
    ref = (rs.randn(80, 3) * 0.8).astype(np.float32)
    src = rs.rand(80, 2).astype(np.float32)
    rj, rt = jnp.asarray(ref), torch.from_numpy(ref)
    pairs = [
        (jax.jit(Jd.dense_gaussian_matrix)(rj), Td.dense_gaussian_matrix(rt)),
        (jax.jit(partial(Jd.dense_gaussian_adjacency, block=32))(jnp.asarray(src), rj),
         Td.dense_gaussian_adjacency(torch.from_numpy(src), rt, block=32)),
        (jax.jit(Jd.gaussian_weights_normalized)(rj), Td.gaussian_weights_normalized(rt)),
        (jax.jit(partial(Jd.affinity_row, i=7))(rj), Td.affinity_row(rt, 7)),
        (jax.jit(partial(Jd.affinity_row, i=3, normalize=False))(rj),
         Td.affinity_row(rt, 3, normalize=False)),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_compat_and_guides_match_jax():
    """The trainable compatibility and guides: values and gradients; the
    guides bit for bit under `jit` with traced scales (their bits decide
    lattice keys)."""
    rs = np.random.RandomState(7)
    img = rs.rand(9, 13, 3).astype(np.float32)
    Q = rs.rand(9, 13, 5).astype(np.float32)
    x = (rs.rand(9, 13, 1) * 4).astype(np.float32)
    labels = np.linspace(0, 4, 5).astype(np.float32)

    jp = {"mu": Jc.charb_init(0.3), "w": Jg.ijrgb_guide_init(0.13, 0.37),
          "ij": Jg.ij_guide_init(0.07)}

    @jax.jit
    def jfn(p):
        a = Jc.charb_apply(p["mu"], jnp.asarray(Q))
        e = Jc.charb_energies_from_scalar(p["mu"], jnp.asarray(x), jnp.asarray(labels))
        im = jnp.asarray(img)
        return Jg.ijrgb_guide(p["w"], im), Jg.ij_guide(p["ij"], im), a, e

    def tfn(p):
        a = Tc.charb_apply(p["mu"], torch.from_numpy(Q))
        e = Tc.charb_energies_from_scalar(p["mu"], torch.from_numpy(x), torch.from_numpy(labels))
        return (Tg.ijrgb_guide(p["w"], torch.from_numpy(img)),
                Tg.ij_guide(p["ij"], torch.from_numpy(img)), a, e)

    tp = {"mu": Tc.charb_init(0.3, device="cpu"),
          "w": Tg.ijrgb_guide_init(0.13, 0.37, device="cpu"),
          "ij": Tg.ij_guide_init(0.07, device="cpu")}
    assert all(v.requires_grad for d in tp.values() for v in d.values())
    outs_j, outs_t = jfn(jp), tfn(tp)
    np.testing.assert_array_equal(outs_t[0].detach().numpy(), np.asarray(outs_j[0]))
    np.testing.assert_array_equal(outs_t[1].detach().numpy(), np.asarray(outs_j[1]))
    for a, b in zip(outs_t[2:], outs_j[2:]):
        _close(a.detach().numpy(), b, rtol=1e-6)
    gj = jax.jit(jax.grad(lambda p: sum(jnp.sum(o ** 2) for o in jfn(p))))(jp)
    sum((o ** 2).sum() for o in tfn(tp)).backward()
    for grp in tp:
        for k, v in tp[grp].items():
            np.testing.assert_allclose(float(v.grad), float(gj[grp][k]), rtol=1e-5)


def test_crf_as_rnn_matches_jax():
    rs = np.random.RandomState(8)
    logits = rs.randn(10, 12, 4).astype(np.float32)
    conf = rs.rand(10, 12, 1).astype(np.float32)
    ref = (rs.randn(120, 3)).astype(np.float32)
    jp = Jc.charb_init(0.2)

    def jloss(p):
        msg = lambda Q: (Jd.dense_gaussian_filter(Q.reshape(120, 4), jnp.asarray(ref), block=40)
                         - Q.reshape(120, 4)).reshape(10, 12, 4)
        out = Jm.crf_as_rnn(jnp.asarray(logits), msg, lambda Q: Jc.charb_apply(p, Q), 2,
                            jnp.asarray(conf))
        return jnp.sum(out ** 2), out

    gj, out_j = jax.jit(jax.grad(jloss, has_aux=True))(jp)
    tp = params_from_jax(jp, device="cpu")
    for v in tp.values():
        v.requires_grad_()
    msg = lambda Q: (Td.dense_gaussian_filter(Q.reshape(120, 4), torch.from_numpy(ref), block=40)
                     - Q.reshape(120, 4)).reshape(10, 12, 4)
    out = Tm.crf_as_rnn(torch.from_numpy(logits), msg, lambda Q: Tc.charb_apply(tp, Q), 2,
                        torch.from_numpy(conf))
    (out ** 2).sum().backward()
    _close(out.detach().numpy(), out_j, rtol=1e-5)
    for k in tp:
        np.testing.assert_allclose(float(tp[k].grad), float(gj[k]), rtol=GRAD_RTOL)
