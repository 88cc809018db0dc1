"""The PyTorch port's task models against the JAX package on the CPU:
`CRFasRNN` (both backends; the lattice one untiled, tiled, and tiled with
the calibrated capacity and pinned 'packed1' sort of the training step),
`CRFDepthRefiner`, `CRFWithUncertainty` and `CRFDepthUpsampler` carry the
JAX params across by `load_jax_params`; their outputs and the gradient of
every parameter equal `jax.grad` of the JAX init/apply pair.

Tolerance: 1e-4 of each output's largest magnitude and of the model's
largest gradient, in float64 on both sides. In float32 the guided filter
(cumsum box filters, E[xx] − E[x]² cancellation, a per-pixel solve) rounds
differently in the two packages by up to ~2e-4 of that scale, so the
float32 runs are held to 1e-3."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_estimation_torch.models import refiner as T
from depth_estimation_torch.utils.weights import load_jax_params
from depth_estimation_tpu.models import refiner as J

TOL = {np.float64: 1e-4, np.float32: 1e-3}
DTYPES = {np.float64: (jnp.float64, torch.float64), np.float32: (jnp.float32, torch.float32)}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}{k}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}{i}.").items()}
    return {prefix[:-1]: np.asarray(tree)}


def _check(port, jparams, jfn, tfn, tol):
    """Outputs, and every parameter's gradient of Σ sum(out²), against
    jax.grad; returns the port's gradients by name."""
    load_jax_params(port, jax.tree.map(np.asarray, jparams), device="cpu")

    def jloss(p):
        outs = jfn(p)
        return sum(jnp.sum(o ** 2) for o in outs), outs

    gj, outs_j = jax.jit(jax.grad(jloss, has_aux=True))(jparams)
    outs_t = tfn(port)
    sum((o ** 2).sum() for o in outs_t).backward()
    for o_t, o_j in zip(outs_t, outs_j):
        o_j = np.asarray(o_j)
        np.testing.assert_allclose(o_t.detach().numpy(), o_j, rtol=0, atol=tol * np.abs(o_j).max())
    grads_j = _flat(gj)
    grads_t = {k: p.grad.numpy() for k, p in port.named_parameters()}
    assert set(grads_t) == set(grads_j)
    scale = max(np.abs(g).max() for g in grads_j.values())
    for name, g in grads_t.items():
        want = grads_j[name]
        if want.ndim == 4:
            want = want.transpose(3, 2, 0, 1)
        np.testing.assert_allclose(g, want, rtol=0, atol=tol * scale, err_msg=name)
    return grads_t


def _inputs(seed, dt, h=16, w=24, L=4, c=3, contrast=1.0):
    rs = np.random.RandomState(seed)
    return (rs.randn(h, w, L).astype(dt),
            (0.5 - contrast / 2 + contrast * rs.rand(h, w, c)).astype(dt))


LATTICE_KW = {
    "untiled": ({}, 1.0),
    "tiled": (dict(tile_px=8, tile_u=384), 1.0),
    # the training step's plan: calibrated capacity, tiles, pinned 'packed1'
    # (a low-contrast guide, whose packed key fits, as the pin requires)
    "packed1": (dict(max_vertices=2048, tile_px=8, tile_u=384, sort_mode="packed1"), 0.1),
}


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("backend,plan", [("guided", None)] + [("lattice", k) for k in LATTICE_KW])
def test_crf_as_rnn_matches_jax(backend, plan, dt):
    kw, contrast = LATTICE_KW[plan] if plan else ({}, 1.0)
    logits, guide = _inputs(0, dt, contrast=contrast)
    jdt, tdt = DTYPES[dt]
    jp = J.crf_rnn_init(gamma=0.05, gchannels=3, backend=backend, dtype=jdt)
    def jfn(p):
        return (J.crf_rnn_apply(p, jnp.asarray(guide), jnp.asarray(logits), niters=2, r=3,
                                backend=backend, **kw),)

    def tfn(m):
        return (m(torch.from_numpy(guide), torch.from_numpy(logits), niters=2, r=3, **kw),)

    port = T.CRFasRNN(gamma=0.05, gchannels=3, backend=backend, dtype=tdt, device="cpu")
    grads = _check(port, jp, jfn, tfn, TOL[dt])
    if backend == "lattice":  # the trainable guide scales get gradient through ∂ref
        assert abs(float(grads["w.s_ij"])) > 0 and abs(float(grads["w.s_rgb"])) > 0


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_refiner_matches_jax(dt):
    logits, img = _inputs(1, dt)
    feats = np.random.RandomState(2).randn(16, 24, 8).astype(dt)
    jdt, tdt = DTYPES[dt]
    jp = J.refiner_init(jax.random.PRNGKey(0), d_in=8, d_guide=6, dtype=jdt)
    jfn = lambda p: (J.refiner_apply(p, jnp.asarray(logits), jnp.asarray(img),  # noqa: E731
                                     jnp.asarray(feats), niters=1, r=3),)
    tfn = lambda m: (m(torch.from_numpy(logits), torch.from_numpy(img),  # noqa: E731
                       torch.from_numpy(feats), niters=1, r=3),)
    _check(T.CRFDepthRefiner(d_in=8, d_guide=6, dtype=tdt, device="cpu"), jp, jfn, tfn, TOL[dt])


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_uncertainty_matches_jax(dt):
    logits, img = _inputs(3, dt)
    feats = np.random.RandomState(4).randn(16, 24, 8).astype(dt)
    jdt, tdt = DTYPES[dt]
    jp = J.uncertainty_init(jax.random.PRNGKey(1), d_in=8, d_guide=6, dtype=jdt)
    jfn = lambda p: J.uncertainty_apply(p, jnp.asarray(logits), jnp.asarray(img),  # noqa: E731
                                        jnp.asarray(feats), niters=1, r=3)
    tfn = lambda m: m(torch.from_numpy(logits), torch.from_numpy(img),  # noqa: E731
                      torch.from_numpy(feats), niters=1, r=3)
    port = T.CRFWithUncertainty(d_in=8, d_guide=6, dtype=tdt, device="cpu")
    assert sorted(k for k, _ in port.named_parameters() if k.startswith("unc")) == [
        f"unc.{i}.{x}" for i in range(3) for x in "bw"]
    _check(port, jp, jfn, tfn, TOL[dt])


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_upsampler_matches_jax(dt):
    rs = np.random.RandomState(5)
    h, w = 32, 48
    disp = np.full((h, w), 2.0, dt)
    disp[:, w // 2:] = 8.0
    img = rs.rand(h, w, 3).astype(dt)
    img[:, w // 2:, 2] += 0.8
    low = disp[::4, ::4] + rs.rand(8, 12).astype(dt)
    jdt, tdt = DTYPES[dt]
    jp = J.upsampler_init(dtype=jdt)
    def jfn(p):
        return (J.upsampler_apply(p, jnp.asarray(low), jnp.asarray(img), niters=2, r=3),)

    def tfn(m):
        return (m(torch.from_numpy(low), torch.from_numpy(img), niters=2, r=3),)

    _check(T.CRFDepthUpsampler(dtype=tdt, device="cpu"), jp, jfn, tfn, TOL[dt])


def test_blocked_round_trip():
    from depth_estimation_torch.models.pipeline import blocked, unblocked

    x = torch.arange(8 * 12 * 2.0).reshape(8, 12, 2)
    assert torch.equal(unblocked(blocked(x, 4), 8, 12, 4), x)
    assert torch.equal(blocked(x, 4)[:16], x[:4, :4].reshape(16, 2))
