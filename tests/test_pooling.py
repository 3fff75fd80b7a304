"""Scene and social pooling (models/scf.py) against explicit references:
per-point bilinear sampling in numpy, and the naive broadcast-difference
form of the distance-kernel attention that social_pool's docstring names."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from desire.models import scf


def _bilinear_np(fm, pos):
    """Per-point align-corners bilinear sample of fm (B, G, G, C) at
    pos (B, P, 2) in [0, 1] (clamped), one point at a time."""
    b, g, _, c = fm.shape
    out = np.zeros(pos.shape[:-1] + (c,), np.float64)
    for bi in range(b):
        for pi in range(pos.shape[1]):
            x, y = np.clip(pos[bi, pi], 0.0, 1.0) * (g - 1)
            x0, y0 = int(np.floor(x)), int(np.floor(y))
            x1, y1 = min(x0 + 1, g - 1), min(y0 + 1, g - 1)
            fx, fy = x - x0, y - y0
            out[bi, pi] = (fm[bi, y0, x0] * (1 - fx) * (1 - fy)
                           + fm[bi, y0, x1] * fx * (1 - fy)
                           + fm[bi, y1, x0] * (1 - fx) * fy
                           + fm[bi, y1, x1] * fx * fy)
    return out


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("grid", [2, 5, 8, 32])
def test_bilinear_pool_matches_per_point_reference(grid, dtype):
    ks = jax.random.split(jax.random.PRNGKey(grid), 2)
    fm = jax.random.normal(ks[0], (2, grid, grid, 3)).astype(dtype)
    pos = jax.random.uniform(ks[1], (2, 17, 2))
    got = np.asarray(scf.bilinear_pool(fm, pos), np.float64)
    want = _bilinear_np(np.asarray(fm, np.float64), np.asarray(pos))
    tol = 1e-5 if dtype == jnp.float32 else 3e-2
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("grid", [2, 8, 32])
def test_bilinear_pool_clamps_outside_the_scene(grid):
    fm = jax.random.normal(jax.random.PRNGKey(0), (1, grid, grid, 4))
    pos = jnp.array([[[-0.3, 0.5], [1.7, 0.2], [0.4, -2.0], [3.0, 9.0],
                      [-1.0, -1.0]]])
    got = scf.bilinear_pool(fm, pos)
    want = scf.bilinear_pool(fm, jnp.clip(pos, 0.0, 1.0))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    # the far corners land exactly on the corner cells
    np.testing.assert_allclose(np.asarray(got[0, 3]),
                               np.asarray(fm[0, -1, -1]), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(got[0, 4]),
                               np.asarray(fm[0, 0, 0]), rtol=1e-6)


@pytest.mark.parametrize("wrt", ["feature_map", "positions"])
def test_bilinear_pool_gradient_matches_finite_differences(wrt):
    ks = jax.random.split(jax.random.PRNGKey(3), 3)
    fm = jax.random.normal(ks[0], (1, 6, 6, 2))
    # keep points inside cells: the interpolant is smooth there
    pos = (jnp.floor(jax.random.uniform(ks[1], (1, 5, 2)) * 5) + 0.3
           + 0.4 * jax.random.uniform(ks[2], (1, 5, 2))) / 5
    w = jax.random.normal(jax.random.PRNGKey(9), (1, 5, 2))

    def f(fm, pos):
        return jnp.sum(scf.bilinear_pool(fm, pos) * w)

    argnum = 0 if wrt == "feature_map" else 1
    x = (fm, pos)[argnum]
    g = np.asarray(jax.grad(f, argnums=argnum)(fm, pos)).ravel()
    eps = 1e-3
    flat = np.asarray(x).ravel()
    num = np.zeros_like(flat)
    for i in range(flat.size):
        up, dn = flat.copy(), flat.copy()
        up[i] += eps
        dn[i] -= eps
        args_up = [fm, pos]
        args_dn = [fm, pos]
        args_up[argnum] = jnp.asarray(up.reshape(x.shape))
        args_dn[argnum] = jnp.asarray(dn.reshape(x.shape))
        num[i] = (float(f(*args_up)) - float(f(*args_dn))) / (2 * eps)
    np.testing.assert_allclose(g, num, atol=2e-3, rtol=2e-3)


def _social_naive(logtau, traj, msg, live):
    """The broadcast-difference form: (B, A, A, K, Tf) squared distances,
    self and dead neighbours masked, softmax over neighbours, weighted sum
    of messages; rows with no live neighbour pool zeros."""
    traj = np.asarray(traj, np.float64)
    msg = np.asarray(msg, np.float64)
    live = np.asarray(live) > 0
    a = traj.shape[1]
    d2 = np.sum((traj[:, :, None] - traj[:, None, :]) ** 2, axis=-1)
    logits = -d2 / (np.exp(logtau) + 1e-4)
    ok = (~np.eye(a, dtype=bool))[None, :, :, None, None] \
        & live[:, None, :, None, None]
    logits = np.where(ok, logits, -np.inf)
    mx = np.max(logits, axis=2, keepdims=True)
    e = np.where(ok, np.exp(logits - np.where(np.isfinite(mx), mx, 0.0)), 0)
    z = np.sum(e, axis=2, keepdims=True)
    w = np.where(z > 0, e / np.where(z > 0, z, 1.0), 0.0)
    return np.einsum("bijkt,bjktd->biktd", w, msg)


def _social_inputs(pattern, dtype, b=2, a=7, k=3, tf=4, d=5, seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 2)
    traj = jax.random.uniform(ks[0], (b, a, k, tf, 2), minval=0.2, maxval=0.8)
    msg = jax.random.normal(ks[1], (b, a, k, tf, d)).astype(dtype)
    live = {"all": np.ones((b, a)),
            "half": np.tile(np.arange(a) % 2 == 0, (b, 1)),
            "single": np.eye(1, a, 2).repeat(b, 0),
            "none": np.zeros((b, a))}[pattern]
    return traj, msg, jnp.asarray(live, jnp.float32)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("pattern", ["all", "half", "single", "none"])
def test_social_pool_matches_broadcast_difference_form(pattern, dtype):
    traj, msg, live = _social_inputs(pattern, dtype)
    logtau = -2.0
    p = {"soc_logtau": jnp.asarray(logtau, jnp.float32)}
    with jax.default_matmul_precision("highest"):
        got = np.asarray(scf.social_pool(p, traj, msg, live), np.float64)
    want = _social_naive(logtau, traj, msg.astype(jnp.float32), live)
    # bf16: positions and messages carry ~3 significant digits, and the
    # bf16 gram-form distances |y_i|^2 + |y_j|^2 - 2 y_i.y_j lose more to
    # cancellation, so the bound scales with the largest message
    scale = float(jnp.max(jnp.abs(msg.astype(jnp.float32))))
    tol = 2e-5 if dtype == jnp.float32 else 3e-2 * scale
    np.testing.assert_allclose(got, want, atol=tol, rtol=2e-5)
    if pattern == "none":
        np.testing.assert_array_equal(got, 0.0)
    if pattern == "single":
        # the lone live agent has no neighbour; dead slots see only it
        np.testing.assert_array_equal(got[:, 2], 0.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_social_pool_is_agent_permutation_equivariant(seed):
    traj, msg, live = _social_inputs("half", jnp.float32, seed=seed)
    perm = np.random.RandomState(seed).permutation(traj.shape[1])
    p = {"soc_logtau": jnp.asarray(-1.0, jnp.float32)}
    with jax.default_matmul_precision("highest"):
        out = scf.social_pool(p, traj, msg, live)
        out_p = scf.social_pool(p, traj[:, perm], msg[:, perm], live[:, perm])
    np.testing.assert_allclose(np.asarray(out_p), np.asarray(out[:, perm]),
                               atol=1e-5, rtol=1e-5)
