"""The bivariate-Gaussian NLL (models/losses.bivariate_nll) against a
float64 numpy reference, its epsilon floor, and its gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from desire.models import losses


def _nll_np(raw, xy, mask):
    """Float64 closed form with the module's clamps and the reference's
    -log(max(pdf, 1e-20)) floor; raw (..., 5), xy (..., 2), mask (...)."""
    raw = np.asarray(raw, np.float64)
    xy = np.asarray(xy, np.float64)
    mux, muy = raw[..., 0], raw[..., 1]
    sx = np.exp(np.clip(raw[..., 2], -9.0, 6.0))
    sy = np.exp(np.clip(raw[..., 3], -9.0, 6.0))
    rho = np.tanh(raw[..., 4]) * 0.999
    nx, ny = (xy[..., 0] - mux) / sx, (xy[..., 1] - muy) / sy
    z = nx ** 2 + ny ** 2 - 2 * rho * nx * ny
    pdf = np.exp(-z / (2 * (1 - rho ** 2))) / (
        2 * np.pi * sx * sy * np.sqrt(1 - rho ** 2))
    return -np.log(np.maximum(pdf, 1e-20)) * mask


def _inputs(k, t, seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    raw = jax.random.normal(ks[0], (3, k, t, 5)) * jnp.array(
        [0.5, 0.5, 0.7, 0.7, 1.0])
    xy = jax.random.normal(ks[1], (3, 1, t, 2)) * 0.5
    mask = (jax.random.uniform(ks[2], (3, 1, t)) < 0.8).astype(jnp.float32)
    return raw, xy, mask


@pytest.mark.parametrize("t", [1, 4, 12])
@pytest.mark.parametrize("k", [1, 3, 20])
def test_bivariate_nll_matches_float64_reference(k, t):
    raw, xy, mask = _inputs(k, t, seed=k * 100 + t)
    got = np.asarray(losses.bivariate_nll(raw, xy, step_mask=mask))
    want = _nll_np(raw, np.broadcast_to(xy, raw.shape[:-1] + (2,)),
                   np.broadcast_to(mask, raw.shape[:-1]))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_bivariate_nll_epsilon_floor_caps_far_points():
    raw = jnp.array([[0.0, 0.0, -3.0, -3.0, 0.0]] * 4)
    xy = jnp.array([[0.0, 0.0], [0.2, 0.0], [5.0, 5.0], [1e4, -1e4]])
    got = np.asarray(losses.bivariate_nll(raw, xy))
    cap = -np.log(1e-20)
    assert got[0] < got[1] < cap                     # close points: unfloored
    np.testing.assert_allclose(got[2:], cap, rtol=1e-6)
    # floor=False keeps the exact (larger) value
    assert float(losses.bivariate_nll(raw, xy, floor=False)[2]) > cap


def test_bivariate_nll_gradient_matches_finite_differences():
    raw, xy, _ = _inputs(2, 3, seed=5)
    w = jax.random.normal(jax.random.PRNGKey(8), raw.shape[:-1])

    def f(r):
        return jnp.sum(losses.bivariate_nll(r, xy) * w)

    g = np.asarray(jax.grad(f)(raw)).ravel()
    flat = np.asarray(raw, np.float64).ravel()
    eps = 1e-3
    num = np.zeros_like(flat)
    for i in range(flat.size):
        up, dn = flat.copy(), flat.copy()
        up[i] += eps
        dn[i] -= eps
        num[i] = (float(f(jnp.asarray(up.reshape(raw.shape), jnp.float32)))
                  - float(f(jnp.asarray(dn.reshape(raw.shape), jnp.float32)))
                  ) / (2 * eps)
    np.testing.assert_allclose(g, num, rtol=1e-2, atol=1e-2)


def test_masked_steps_get_zero_gradient():
    raw, xy, _ = _inputs(3, 6, seed=2)
    mask = jnp.array([1.0, 0.0, 1.0, 0.0, 0.0, 1.0])
    g = jax.grad(lambda r: jnp.sum(losses.bivariate_nll(
        r, xy, step_mask=mask)))(raw)
    g = np.asarray(g)
    np.testing.assert_array_equal(g[:, :, mask == 0], 0.0)
    assert np.all(np.abs(g[:, :, mask == 1]).sum(-1) > 0)
