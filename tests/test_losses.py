"""Loss math vs closed form (SURVEY.md §4: unit tier)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from desire.models import losses


def _np_bivariate_pdf(x, y, mux, muy, sx, sy, rho):
    # Direct transcription of the Graves (2013) eq 24-25 pdf used by the
    # reference (model/model.py:494-523), in numpy for independence.
    nx, ny = x - mux, y - muy
    z = (nx / sx) ** 2 + (ny / sy) ** 2 - 2 * rho * nx * ny / (sx * sy)
    neg = 1 - rho**2
    return np.exp(-z / (2 * neg)) / (2 * np.pi * sx * sy * np.sqrt(neg))


def test_log_pdf_matches_closed_form():
    rng = np.random.RandomState(0)
    x, y = rng.randn(64), rng.randn(64)
    mux, muy = rng.randn(64), rng.randn(64)
    sx, sy = np.exp(rng.randn(64) * 0.3), np.exp(rng.randn(64) * 0.3)
    rho = np.tanh(rng.randn(64)) * 0.9
    got = losses.bivariate_gaussian_log_pdf(
        jnp.array(x), jnp.array(y), jnp.array(mux), jnp.array(muy),
        jnp.array(sx), jnp.array(sy), jnp.array(rho))
    want = np.log(_np_bivariate_pdf(x, y, mux, muy, sx, sy, rho))
    np.testing.assert_allclose(np.asarray(got), want, rtol=5e-4, atol=5e-4)


def test_log_pdf_integrates_to_one():
    # Grid-integrate the pdf over a wide box: should be ~1.
    g = np.linspace(-8, 8, 401)
    xx, yy = np.meshgrid(g, g)
    logp = losses.bivariate_gaussian_log_pdf(
        jnp.array(xx), jnp.array(yy), 0.3, -0.2, 1.1, 0.7, 0.5)
    total = np.trapezoid(np.trapezoid(np.exp(np.asarray(logp)), g, axis=1), g)
    assert abs(total - 1.0) < 1e-3


def test_nll_floor_matches_reference_epsilon():
    # Far-out point: pdf underflows; reference floors at -log(1e-20).
    raw = jnp.array([0.0, 0.0, -2.0, -2.0, 0.0] )  # tight gaussian at origin
    target = jnp.array([1000.0, 1000.0])
    nll = losses.bivariate_nll(raw[None], target[None])
    np.testing.assert_allclose(np.asarray(nll), -np.log(1e-20), rtol=1e-6)


def test_kld_matches_closed_form_and_is_zero_at_prior():
    rng = np.random.RandomState(1)
    mean = rng.randn(4, 16).astype(np.float32)
    log_var = (rng.randn(4, 16) * 0.1).astype(np.float32)
    got = losses.kld_normal(jnp.array(mean), jnp.array(log_var))
    want = -0.5 * np.sum(1 + log_var - mean**2 - np.exp(log_var), axis=-1)
    np.testing.assert_allclose(np.asarray(got), want, rtol=5e-4, atol=5e-4)
    # KL(N(0,I)||N(0,I)) == 0
    zero = losses.kld_normal(jnp.zeros((3, 8)), jnp.zeros((3, 8)))
    np.testing.assert_allclose(np.asarray(zero), 0.0, atol=1e-7)
    # KL is nonnegative
    assert np.all(np.asarray(got) >= -1e-6)


def test_masked_mean_ignores_dead_agents():
    vals = jnp.array([1.0, 2.0, 100.0, 4.0])
    mask = jnp.array([1.0, 1.0, 0.0, 1.0])
    np.testing.assert_allclose(
        float(losses.masked_mean(vals, mask)), (1 + 2 + 4) / 3, rtol=1e-6)


def test_agent_validity_requires_both_frames():
    src = jnp.array([1.0, 2.0, 0.0, 4.0])
    tgt = jnp.array([1.0, 0.0, 3.0, 4.0])
    np.testing.assert_array_equal(
        np.asarray(losses.agent_validity_mask(src, tgt)), [1, 0, 0, 1])


def test_get_coef_transforms():
    raw = jnp.array([[1.0, -2.0, 0.5, -0.5, 0.3]])
    mux, muy, sx, sy, rho = losses.get_coef(raw)
    np.testing.assert_allclose(float(mux[0]), 1.0, rtol=1e-5)
    np.testing.assert_allclose(float(muy[0]), -2.0, rtol=1e-5)
    np.testing.assert_allclose(float(sx[0]), np.exp(0.5), rtol=1e-5)
    np.testing.assert_allclose(float(sy[0]), np.exp(-0.5), rtol=1e-5)
    np.testing.assert_allclose(float(rho[0]), np.tanh(0.3) * 0.999, rtol=1e-4)


def test_ioc_cross_entropy_prefers_correct_ranking():
    # Hypothesis 0 is exactly the GT; a score vector ranking it first must
    # have lower CE than one ranking it last.
    K, T = 4, 6
    rng = np.random.RandomState(2)
    gt = jnp.array(rng.randn(T, 2).astype(np.float32))
    hyps = jnp.stack([gt + 0.5 * i for i in range(K)])  # (K, T, 2)
    mask = jnp.array(1.0)
    good = losses.ioc_cross_entropy(jnp.array([5.0, 1.0, 0.0, -1.0]),
                                    hyps, gt, mask)
    bad = losses.ioc_cross_entropy(jnp.array([-1.0, 0.0, 1.0, 5.0]),
                                   hyps, gt, mask)
    assert float(good) < float(bad)


def test_ioc_cross_entropy_target_is_scale_free():
    """Regression (round-2 finding): with raw-unit distances the CE target
    went uniform once lane spreads shrank below the temperature, pinning the
    train CE at ln(K) — standardized distances keep the target equally sharp
    at ANY scene/error scale, so uniform scores are never a CE optimum."""
    K, T = 8, 6
    rng = np.random.RandomState(4)
    gt = jnp.array(rng.randn(T, 2).astype(np.float32))
    uniform = jnp.zeros(K)
    sharp = None
    for scale in (1.0, 1e-2, 1e-4):   # lane spreads over 4 orders of magnitude
        hyps = jnp.stack([gt + scale * i for i in range(K)])
        ce_uniform = losses.ioc_cross_entropy(uniform, hyps, gt,
                                              jnp.array(1.0), temperature=0.5)
        # uniform scores must NOT be near-optimal: a correct ranking beats
        # them by a margin that does not vanish with the distance scale
        good_scores = -jnp.arange(K, dtype=jnp.float32) * 2
        ce_good = losses.ioc_cross_entropy(good_scores, hyps, gt,
                                           jnp.array(1.0), temperature=0.5)
        margin = float(ce_uniform - ce_good)
        assert margin > 0.3, f"scale {scale}: margin {margin}"
        sharp = margin if sharp is None else sharp
        # ~1%: the eps guard inside the distance norm shows up at tiny scales
        np.testing.assert_allclose(margin, sharp, rtol=2e-2)


def test_refine_regression_zero_at_gt():
    T, K = 5, 3
    gt = jnp.ones((T, 2))
    refined = jnp.broadcast_to(gt, (K, T, 2))
    assert float(losses.refine_regression_loss(refined, gt, jnp.array(1.0))) == 0.0


def test_sample_bivariate_statistics():
    # Large-sample mean/cov must match the parameterized gaussian.
    n = 200_000
    raw = jnp.broadcast_to(
        jnp.array([0.5, -1.0, np.log(2.0), np.log(0.5), np.arctanh(0.6)]),
        (n, 5))
    pts = losses.sample_bivariate(raw, jax.random.PRNGKey(0))
    pts = np.asarray(pts)
    np.testing.assert_allclose(pts.mean(0), [0.5, -1.0], atol=0.02)
    cov = np.cov(pts.T)
    rho_eff = 0.6 * 0.999  # get_coef clamps rho
    np.testing.assert_allclose(cov[0, 0], 4.0, rtol=0.03)
    np.testing.assert_allclose(cov[1, 1], 0.25, rtol=0.03)
    np.testing.assert_allclose(cov[0, 1], rho_eff * 2.0 * 0.5, rtol=0.05)


def test_losses_jit_and_grad():
    # Everything must be differentiable and jit-safe.
    def loss_fn(raw):
        tgt = jnp.ones(raw.shape[:-1] + (2,))
        return jnp.sum(losses.bivariate_nll(raw, tgt))
    raw = jnp.zeros((4, 5))
    g = jax.jit(jax.grad(loss_fn))(raw)
    assert np.all(np.isfinite(np.asarray(g)))


def test_ioc_ce_gradient_does_not_move_trajectories():
    """The CE's distance-derived target is a target: no gradient may flow
    into the hypothesis trajectories through it (a missing stop_gradient
    was measured to drag refined hypotheses ~100px away from GT)."""
    K, T = 3, 4
    rng = np.random.RandomState(0)
    gt = jnp.array(rng.randn(T, 2).astype(np.float32))
    hyps = jnp.array(rng.randn(K, T, 2).astype(np.float32))
    scores = jnp.array(rng.randn(K).astype(np.float32))

    g_hyp = jax.grad(lambda h: losses.ioc_cross_entropy(
        scores, h, gt, jnp.array(1.0)))(hyps)
    np.testing.assert_allclose(np.asarray(g_hyp), 0.0, atol=1e-8)
    # ... while the scores side does learn
    g_sc = jax.grad(lambda s: losses.ioc_cross_entropy(
        s, hyps, gt, jnp.array(1.0)))(scores)
    assert float(jnp.abs(g_sc).max()) > 0


def test_refine_regression_min_agg():
    T, K = 4, 3
    gt = jnp.zeros((T, 2))
    refined = jnp.stack([jnp.zeros((T, 2)),            # perfect lane
                         jnp.ones((T, 2)) * 5.0,       # far lanes
                         jnp.ones((T, 2)) * -3.0])
    # min agg: only the perfect lane counts -> zero loss
    assert float(losses.refine_regression_loss(
        refined, gt, jnp.array(1.0), agg="min")) == 0.0
    assert float(losses.refine_regression_loss(
        refined, gt, jnp.array(1.0), agg="mean")) > 0


def test_kld_gaussians_reduces_and_matches_closed_form():
    """kld_gaussians == kld_normal at a standard prior, and matches the
    analytic diagonal-Gaussian KL for a non-trivial prior (cond_prior)."""
    key = jax.random.PRNGKey(0)
    mq, lq = jax.random.normal(key, (5, 8)), 0.3 * jax.random.normal(
        jax.random.PRNGKey(1), (5, 8))
    zeros = jnp.zeros_like(mq)
    np.testing.assert_allclose(
        np.asarray(losses.kld_gaussians(mq, lq, zeros, zeros)),
        np.asarray(losses.kld_normal(mq, lq)), rtol=1e-6)

    mp_, lp = 0.5 * jnp.ones_like(mq), 0.7 * jnp.ones_like(mq)
    # closed form: 0.5 * (lp - lq - 1 + (vq + (mq-mp)^2)/vp) per dim
    vq, vp = np.exp(np.asarray(lq)), np.exp(np.asarray(lp))
    expect = 0.5 * (np.asarray(lp) - np.asarray(lq) - 1
                    + (vq + (np.asarray(mq) - np.asarray(mp_)) ** 2) / vp)
    np.testing.assert_allclose(
        np.asarray(losses.kld_gaussians(mq, lq, mp_, lp)),
        expect.sum(-1), rtol=1e-5)
    # KL(p || p) == 0
    np.testing.assert_allclose(
        np.asarray(losses.kld_gaussians(mp_, lp, mp_, lp)), 0.0, atol=1e-6)


def test_refine_regression_lane_penalty_restricts_min():
    """The variety-subset penalty excludes lanes from the min (variety_k)."""
    gt = jnp.zeros((1, 1, 3, 2))
    # lane 0 is perfect, lane 1 is off by 1
    refined = jnp.stack([jnp.zeros((3, 2)), jnp.ones((3, 2))])[None, None]
    live = jnp.ones((1, 1))
    base = losses.refine_regression_loss(refined, gt, live)
    assert float(base) == 0.0
    pen = jnp.asarray([[[1e9, 0.0]]])       # exclude the perfect lane
    masked = losses.refine_regression_loss(refined, gt, live,
                                           lane_penalty=pen)
    np.testing.assert_allclose(float(masked), 2.0, rtol=1e-5)  # |(1,1)|^2
