"""The port's augmentation pixel functions against the JAX package's
transforms, fed the draws JAX makes (each JAX transform's keys split and
drawn here exactly as the transform draws them), on non-square [0, 1]
images; and DropPath and Dropout against their formula, given the mask
their generator draws.

Tolerance 5e-6 absolute on [0, 1] pixels: bilinear weights and sums in
f32, in the same order as `map_coordinates`, at sample coordinates whose
last bits differ (the crop's f32 `linspace` in torch and in jnp); exact for
flips.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geovpr.data import transforms as jt
from geovpr_torch.data import transforms as tt
from geovpr_torch.models.layers import Dropout, DropPath, set_rng


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small shapes: the test workers share
    the cores, and torch's thread pool oversubscribed by them runs the
    tiny ops tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 5e-6


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return rng.random((4, 16, 20, 3)).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def test_resized_crop(images):
    key = jax.random.PRNGKey(1)
    b = images.shape[0]
    ak, rk, yk, xk = jax.random.split(key, 4)
    draws = dict(area=jax.random.uniform(ak, (b,), minval=0.8, maxval=1.0),
                 aspect=jax.random.uniform(rk, (b,), minval=0.9, maxval=1.1),
                 yu=jax.random.uniform(yk, (b,)),
                 xu=jax.random.uniform(xk, (b,)))
    want = jt.random_resized_crop(key, jnp.asarray(images))
    got = tt.resized_crop(_t(images), **{k: _t(v) for k, v in draws.items()})
    _close(got, want)


def test_flip(images):
    key = jax.random.PRNGKey(2)
    want, jflip = jt.random_flip(key, jnp.asarray(images))
    flipped = _t(jax.random.bernoulli(key, 0.5, (images.shape[0],)))
    assert np.array_equal(flipped.numpy(), np.asarray(jflip))
    np.testing.assert_array_equal(tt.flip(_t(images), flipped).numpy(),
                                  np.asarray(want))


def test_color_jitter(images):
    key = jax.random.PRNGKey(3)
    b = images.shape[0]
    ks = jax.random.split(key, 3)
    f = [jax.random.uniform(k, (b, 1, 1, 1), minval=0.8, maxval=1.2)
         for k in ks]
    want = jt.color_jitter(key, jnp.asarray(images))
    got = tt.color_jitter(_t(images), *(_t(np.asarray(v).reshape(b))
                                        for v in f))
    _close(got, want)


@pytest.mark.parametrize("max_degrees", [15.0, 45.0])
def test_rotate(images, max_degrees):
    key = jax.random.PRNGKey(4)
    angles = jax.random.uniform(key, (images.shape[0],),
                                minval=-max_degrees,
                                maxval=max_degrees) * (jnp.pi / 180.0)
    want = jt.random_rotate(key, jnp.asarray(images), max_degrees)
    _close(tt.rotate(_t(images), _t(angles)), want)


def test_affine(images):
    """`affine` given `random_affine`'s draws (zoom, then the shift as
    fractions of the width and height), and `draw_affine`'s ranges."""
    key = jax.random.PRNGKey(6)
    b, h, w, _ = images.shape
    ks, kx, ky = jax.random.split(key, 3)
    s = jax.random.uniform(ks, (b,), minval=0.9, maxval=1.1)
    tx = jax.random.uniform(kx, (b,), minval=-0.1, maxval=0.1) * w
    ty = jax.random.uniform(ky, (b,), minval=-0.1, maxval=0.1) * h
    want = jt.random_affine(key, jnp.asarray(images))
    _close(tt.affine(_t(images), _t(s), _t(tx), _t(ty)), want)
    d = tt.draw_affine(torch.Generator().manual_seed(0), 64, h, w)
    assert float(d["s"].min()) >= 0.9 and float(d["s"].max()) < 1.1
    assert float(d["tx"].abs().max()) <= 0.1 * w
    assert float(d["ty"].abs().max()) <= 0.1 * h


def test_gauss_noise(images):
    key = jax.random.PRNGKey(5)
    b = images.shape[0]
    ka, kv, kn = jax.random.split(key, 3)
    draws = dict(apply=jax.random.bernoulli(ka, 0.6, (b,)),
                 var=jax.random.uniform(kv, (b,), minval=10.0, maxval=50.0),
                 noise=jax.random.normal(kn, images.shape))
    assert 0 < int(np.asarray(draws["apply"]).sum()) < b
    want = jt.gauss_noise(key, jnp.asarray(images), p=0.6)
    got = tt.gauss_noise(_t(images), **{k: _t(v) for k, v in draws.items()})
    _close(got, want)


def test_bilinear_modes_at_edges():
    """Samples outside the image: `nearest` repeats the edge, `constant`
    counts each out-of-range corner as 0, as map_coordinates does."""
    img = np.arange(12, dtype=np.float32).reshape(1, 3, 4, 1)
    sy = np.array([[[-0.5, 1.25, 2.5]]], np.float32)
    sx = np.array([[[-0.25, 3.5, 1.0]]], np.float32)
    for mode in ("nearest", "constant"):
        want = jax.scipy.ndimage.map_coordinates(
            img[0, ..., 0], [sy.ravel(), sx.ravel()], order=1, mode=mode,
            cval=0.0)
        got = tt.bilinear_sample(_t(img), _t(sy), _t(sx), mode)
        np.testing.assert_allclose(got.numpy().ravel(), np.asarray(want),
                                   atol=ATOL)


@pytest.mark.parametrize("name", ["geo_light", "geo_heavy", "angle_rot",
                                  "none"])
def test_build_augment(images, name):
    g = torch.Generator().manual_seed(0)
    out, flipped = tt.build_augment(name)(g, _t(images))
    assert out.shape == images.shape and flipped.dtype == torch.bool
    assert bool(torch.isfinite(out).all())
    if name == "none":
        assert torch.equal(out, _t(images)) and not flipped.any()
    if name == "angle_rot":
        # rotate 45, affine, jitter from the draws in that order; no flip
        g = torch.Generator().manual_seed(0)
        b, h, w, _ = images.shape
        x = tt.rotate(_t(images), tt.draw_rotate(g, b, 45.0))
        x = tt.affine(x, **tt.draw_affine(g, b, h, w))
        x = tt.color_jitter(x, **tt.draw_jitter(g, b))
        assert torch.equal(out, x) and not flipped.any()


@pytest.mark.parametrize("cls,rate", [(DropPath, 0.3), (Dropout, 0.3),
                                      (Dropout, 1.0)])
def test_drop_given_mask(cls, rate):
    """Training mode: where(mask, x / keep, 0) with the mask the generator
    draws (per sample for DropPath, per element for Dropout); identity in
    eval mode."""
    x = torch.randn(6, 5, 4)
    m = cls(rate).train()
    set_rng(m, torch.Generator().manual_seed(7))
    got = m(x)
    keep = 1.0 - rate
    if rate >= 1.0:
        want = torch.zeros_like(x)
    else:
        shape = (6, 1, 1) if cls is DropPath else x.shape
        mask = torch.rand(shape, generator=torch.Generator().manual_seed(
            7)) < keep
        want = torch.where(mask, x / keep, torch.zeros_like(x))
    assert torch.equal(got, want)
    assert torch.equal(m.eval()(x), x)
    assert math.isclose(m.rate, rate)
