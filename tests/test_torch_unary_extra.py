"""The unary layer's remaining functions against the JAX package's, on the
same float32 inputs from numpy seeds: the cost volume where the symmetric
pad is longer than a side, the Gaussian blurs (with the σ gradient), the
matching criteria, `disparity_badness` and `ncc_template_disparity`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_estimation_torch.ops import boxfilter as Tb
from depth_estimation_torch.ops import costvolume as Tcv
from depth_estimation_tpu.ops import boxfilter as Jb
from depth_estimation_tpu.ops import costvolume as Jcv


def _arr(seed, *shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@pytest.mark.parametrize("h,w,window,labels", [(3, 20, 9, 4), (2, 5, 7, 3), (1, 12, 5, 2)])
def test_cost_volume_pad_longer_than_a_side(h, w, window, labels):
    """numpy's 'symmetric' keeps reflecting where the pad exceeds the side,
    so the volume keeps its shape and JAX's values."""
    left, right = _arr(0, h, w, 3), _arr(1, h, w, 3)
    want = np.asarray(Jcv.cost_volume(jnp.asarray(left), jnp.asarray(right), labels, window))
    got = Tcv.cost_volume(torch.from_numpy(left), torch.from_numpy(right), labels, window).numpy()
    assert got.shape == want.shape == (h, w, labels)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,r", [(3, 4), (2, 3), (1, 4), (5, 12)])
def test_symmetric_pad_matches_numpy_past_the_side(n, r):
    x = _arr(2, n, n + 1, 2)
    want = np.pad(x, ((r, r), (r, r), (0, 0)), mode="symmetric")
    np.testing.assert_array_equal(Tcv._symmetric_pad2d(torch.from_numpy(x), r).numpy(), want)


def test_gaussian_blur_impulse_matches_jax():
    n, sigma, radius = 41, 2.0, 10
    x = np.zeros(n, np.float32)
    x[n // 2] = 1.0
    want = np.asarray(Jb.gaussian_blur(jnp.asarray(x), sigma, axis=0, radius=radius))
    got = Tb.gaussian_blur(torch.from_numpy(x), sigma, axis=0, radius=radius).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert abs(got.sum() - 1.0) < 1e-6


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_gaussian_blur_default_radius_on_an_image(axis):
    x = _arr(3, 12, 16, 3)
    want = np.asarray(Jb.gaussian_blur(jnp.asarray(x), 1.3, axis=axis))
    got = Tb.gaussian_blur(torch.from_numpy(x), 1.3, axis=axis).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sigma,niters", [(4.0, 3), (1.0, 3), (2.5, 4), (0.3, 3)])
def test_box_radius_and_box_blur_match_jax(sigma, niters):
    assert Tb.box_radius_for_sigma(sigma, niters) == Jb.box_radius_for_sigma(sigma, niters)
    n = 101
    x = np.zeros(n, np.float32)
    x[n // 2] = 1.0
    want = np.asarray(Jb.gaussian_blur_box(jnp.asarray(x), sigma, axis=0, niters=niters))
    got = Tb.gaussian_blur_box(torch.from_numpy(x), sigma, axis=0, niters=niters).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_gaussian_blur_sigma_gradient_matches_jax():
    """d/dσ of a matching loss, by autograd and by jax.grad, on
    tests/test_boxfilter.py's σ-recovery problem."""
    n, true_sigma, radius = 61, 3.0, 15
    x = np.random.RandomState(4).randn(n).astype(np.float32)

    def jloss(sigma):
        target = Jb.gaussian_blur(jnp.asarray(x), true_sigma, axis=0, radius=radius)
        out = Jb.gaussian_blur(jnp.asarray(x), sigma, axis=0, radius=radius)
        return jnp.sum((out - target) ** 2)

    xt = torch.from_numpy(x)
    target = Tb.gaussian_blur(xt, true_sigma, axis=0, radius=radius)
    for s0 in (2.0, 2.5, 4.0):
        sigma = torch.tensor(s0, requires_grad=True)
        loss = ((Tb.gaussian_blur(xt, sigma, axis=0, radius=radius) - target) ** 2).sum()
        loss.backward()
        want = float(jax.grad(jloss)(jnp.float32(s0)))
        np.testing.assert_allclose(float(sigma.grad), want, rtol=1e-5)
        assert (float(sigma.grad) > 0) == (s0 > true_sigma)


@pytest.mark.parametrize("name", ["absolute_difference", "squared_difference", "neg_product"])
def test_criteria_match_jax(name):
    a, b = _arr(5, 8, 9, 3), _arr(6, 8, 9, 3)
    want = np.asarray(getattr(Jcv, name)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(Tcv, name)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("criterion", ["absolute_difference", "squared_difference",
                                       "neg_product"])
def test_disparity_badness_matches_jax(criterion):
    """The default sweep is w // 6 labels (5 at w = 32)."""
    left, right = _arr(7, 16, 32, 3), _arr(8, 16, 32, 3)
    want = np.asarray(Jcv.disparity_badness(jnp.asarray(left), jnp.asarray(right),
                                            window_size=5, criterion=getattr(Jcv, criterion)))
    got = Tcv.disparity_badness(torch.from_numpy(left), torch.from_numpy(right), window_size=5,
                                criterion=getattr(Tcv, criterion)).numpy()
    assert got.shape == want.shape == (16, 32, 32 // 6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_disparity_badness_explicit_labels():
    left, right = _arr(9, 12, 20, 3), _arr(10, 12, 20, 3)
    got = Tcv.disparity_badness(torch.from_numpy(left), torch.from_numpy(right), num_disp=7)
    want = Tcv.cost_volume(torch.from_numpy(left), torch.from_numpy(right), 7, 9)
    assert torch.equal(got, want)


@pytest.mark.parametrize("seed,top,col", [(0, 10, 5), (1, 3, 40), (2, 20, 28)])
def test_ncc_template_disparity_matches_jax(seed, top, col):
    """tests/test_costvolume.py's case and two more: the same peak column
    (the correlation's argmax, folded to min(j, w − j)) as JAX's."""
    img = np.random.RandomState(seed).rand(32, 64, 3).astype(np.float32)
    template = img[top:top + 8, col:col + 8]
    want = int(Jcv.ncc_template_disparity(jnp.asarray(img), jnp.asarray(template)))
    got = Tcv.ncc_template_disparity(torch.from_numpy(img), torch.from_numpy(template))
    assert got.dtype == torch.int64 and int(got) == want
    assert 0 <= int(got) <= 32
