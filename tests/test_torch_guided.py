"""The PyTorch port's guided filter and feature extractors against the JAX
package on the CPU (1e-4 absolute): both coefficient solves, the fast
filter, the trainable guided adjacency with its gradient, `FeatureCNN` and
`VGG16Features` with the flax weights carried across by `load_jax_params`,
and `random_features` with the JAX projection carried across."""
import importlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_estimation_torch.models import features as Tf
from depth_estimation_torch.ops import guided_filter as Tgf
from depth_estimation_torch.utils.weights import load_jax_params, params_from_jax
from depth_estimation_tpu.models import features as Jf

# the JAX package's `ops` namespace exports a function of the module's name
Jgf = importlib.import_module("depth_estimation_tpu.ops.guided_filter")

ATOL = 1e-4


def _img(seed, h=18, w=26, c=3):
    return np.random.RandomState(seed).rand(h, w, c).astype(np.float32)


@pytest.mark.parametrize("exact", [True, False])
def test_guided_filter_coeffs_match_jax(exact):
    y, x = _img(0, c=2), _img(1)
    eps = np.array([1e-2, 2e-2, 5e-2], np.float32)
    Aj, bj = jax.jit(partial(Jgf.guided_filter_coeffs, r=2, exact=exact))(
        jnp.asarray(y), jnp.asarray(x), eps=jnp.asarray(eps))
    At, bt = Tgf.guided_filter_coeffs(torch.from_numpy(y), torch.from_numpy(x), 2,
                                      torch.from_numpy(eps), exact=exact)
    np.testing.assert_allclose(At.numpy(), np.asarray(Aj), rtol=0, atol=ATOL)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=0, atol=ATOL)
    want = np.asarray(jax.jit(partial(Jgf.guided_filter, r=2, eps=1e-2))(jnp.asarray(y),
                                                                          jnp.asarray(x)))
    got = Tgf.guided_filter(torch.from_numpy(y), torch.from_numpy(x), 2, 1e-2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("hw,subsample", [((18, 26), 2), ((21, 31), 3)])
def test_fast_guided_filter_matches_jax(hw, subsample):
    y, x = _img(2, *hw, c=4), _img(3, *hw)
    want = jax.jit(partial(Jgf.fast_guided_filter, r=5, eps=1e-2, subsample=subsample))(
        jnp.asarray(y), jnp.asarray(x))
    got = Tgf.fast_guided_filter(torch.from_numpy(y), torch.from_numpy(x), 5, 1e-2, subsample)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_guided_adjacency_and_its_omega_gradient_match_jax():
    src, guide = _img(4, c=5), _img(5, c=4)
    jp = Jgf.guided_adjacency_init(4, eps=1e-2)

    def jloss(p):
        out = Jgf.guided_adjacency_apply(p, jnp.asarray(src), jnp.asarray(guide), 3)
        return jnp.sum(out ** 2), out

    gj, want = jax.jit(jax.grad(jloss, has_aux=True))(jp)
    tp = Tgf.guided_adjacency_init(4, eps=1e-2, device="cpu")
    np.testing.assert_allclose(tp["omega"].detach().numpy(), np.asarray(jp["omega"]), rtol=1e-6)
    out = Tgf.guided_adjacency_apply(tp, torch.from_numpy(src), torch.from_numpy(guide), 3)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=0,
                               atol=ATOL * np.abs(want).max())
    g = np.asarray(gj["omega"])
    np.testing.assert_allclose(tp["omega"].grad.numpy(), g, rtol=0, atol=ATOL * np.abs(g).max())
    want = jax.jit(partial(Jgf.guided_adjacency, r=3, eps=2e-2))(jnp.asarray(src),
                                                                 jnp.asarray(guide))
    got = Tgf.guided_adjacency(torch.from_numpy(src), torch.from_numpy(guide), 3, 2e-2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL * np.abs(np.asarray(want)).max())


def test_feature_cnn_matches_jax():
    img = _img(6, 20, 28)
    model = Jf.FeatureCNN(out_dim=16, widths=(8, 16))
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(img))
    want = np.asarray(jax.jit(model.apply)(params, jnp.asarray(img)))
    port = Tf.FeatureCNN(out_dim=16, widths=(8, 16), device="cpu")
    load_jax_params(port, jax.tree.map(np.asarray, params), device="cpu")
    got = port(torch.from_numpy(img)).detach().numpy()
    assert got.shape == (20, 28, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_vgg16_features_match_jax():
    img = _img(7, 16, 24)
    model = Jf.VGG16Features()
    params = model.init(jax.random.PRNGKey(1), jnp.asarray(img))
    want = np.asarray(jax.jit(model.apply)(params, jnp.asarray(img)))
    port = Tf.VGG16Features(device="cpu")
    load_jax_params(port, jax.tree.map(np.asarray, params), device="cpu")
    with torch.no_grad():
        got = port(torch.from_numpy(img)).numpy()
    assert got.shape == (16, 24, 960)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL * max(1.0, np.abs(want).max()))


def test_random_features_match_jax_with_its_projection():
    img = _img(8)
    want = np.asarray(jax.jit(partial(Jf.random_features, out_dim=8, seed=3))(jnp.asarray(img)))
    proj = np.array(jax.random.normal(jax.random.PRNGKey(3), (27, 8), jnp.float32))
    got = Tf.random_features(torch.from_numpy(img), out_dim=8, proj=torch.from_numpy(proj))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    a = Tf.random_features(torch.from_numpy(img), 8, generator=torch.Generator().manual_seed(3))
    b = Tf.random_features(torch.from_numpy(img), 8, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and abs(float(a.mean())) < 0.1 and abs(float(a.std()) - 1) < 0.1


def test_load_jax_params_refuses_a_tree_that_does_not_fit():
    port = Tf.FeatureCNN(out_dim=4, widths=(8,), device="cpu")
    tree = {"params": {name.replace(".weight", ".kernel"): p.detach().numpy()
                       for name, p in port.named_parameters()}}
    nested = {}
    for k, v in tree["params"].items():
        mod, leaf = k.split(".")
        if mod.startswith("Conv") and leaf == "kernel":
            v = v.transpose(2, 3, 1, 0)
        if mod.startswith("GroupNorm") and leaf == "kernel":
            leaf = "scale"
        nested.setdefault(mod, {})[leaf] = v
    x = torch.from_numpy(_img(9, 8, 8))
    before = port(x).detach()
    load_jax_params(port, {"params": nested}, device="cpu")  # a round trip changes nothing
    assert torch.equal(port(x).detach(), before)
    extra = {"params": {**nested, "Conv_9": {"kernel": np.zeros((1, 1, 8, 4), np.float32)}}}
    with pytest.raises(ValueError, match="Conv_9"):
        load_jax_params(port, extra, device="cpu")
    missing = {"params": {k: v for k, v in nested.items() if k != "Conv_2"}}
    with pytest.raises(ValueError, match="Conv_2"):
        load_jax_params(port, missing, device="cpu")
    wrong = {"params": {**nested, "Conv_2": {"kernel": np.zeros((1, 1, 8, 5), np.float32),
                                             "bias": np.zeros(5, np.float32)}}}
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(port, wrong, device="cpu")
    assert params_from_jax({"a": np.ones(2)}, device="cpu")["a"].shape == (2,)
