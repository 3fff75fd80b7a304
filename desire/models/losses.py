"""Loss math for DESIRE.

Reimplements (in numerically-stable log domain) the loss semantics of the
reference:

* bivariate-Gaussian NLL  -> reference ``tf_2d_normal`` + ``get_reconstr_loss``
  (/root/reference/model/model.py:494-550): pdf per Graves (2013) eq. 24-25,
  then ``-log(max(pdf, 1e-20))`` summed over steps.
* KL divergence           -> reference ``kld_loss`` (model/model.py:567-593):
  ``-0.5 * sum(1 + logvar - mu^2 - exp(logvar))``, averaged over the batch.
* valid-agent masked mean -> reference masked cost accumulation
  (model/model.py:351-366): only agents present in both source and target
  frames contribute; the mean divides by the live-agent count.
* coefficient extraction  -> reference ``get_coef`` (model/model.py:552-565):
  raw 5-vector -> (mu_x, mu_y, exp->sigma_x, exp->sigma_y, tanh->rho).

The IOC cross-entropy and refinement-regression terms have **no** reference
implementation (the module is absent; insertion point marked at
model/model.py:312-313); they follow the DESIRE paper (Lee et al., CVPR'17,
eq. 5-7): max-ent IOC cross-entropy between accumulated hypothesis scores and
a soft target distribution derived from distance-to-ground-truth, plus an L2
regression on the refined trajectories.

All functions are pure jnp, shape-polymorphic, and jit/vmap/pjit-safe.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

# Matches the reference's numerical-stability floor (model/model.py:544).
# (python float, not jnp: module import must not initialize a jax backend)
_PDF_EPS = 1e-20
_LOG_PDF_FLOOR = math.log(_PDF_EPS)  # ~ -46.05
# Stability bounds for exp() on raw log-sigma outputs.
_LOG_SIGMA_MIN = -9.0
_LOG_SIGMA_MAX = 6.0
_RHO_MAX = 0.999


def get_coef(raw: jnp.ndarray):
    """Split a (..., 5) raw decoder output into bivariate-Gaussian params.

    Mirrors reference ``get_coef`` (model/model.py:552-565): stds are
    exponentiated, correlation is tanh-squashed. Adds clamps for stability
    (documented deviation; the reference overflows for large activations).
    """
    mux, muy, log_sx, log_sy, raw_rho = jnp.split(raw, 5, axis=-1)
    sx = jnp.exp(jnp.clip(log_sx, _LOG_SIGMA_MIN, _LOG_SIGMA_MAX))
    sy = jnp.exp(jnp.clip(log_sy, _LOG_SIGMA_MIN, _LOG_SIGMA_MAX))
    rho = jnp.tanh(raw_rho) * _RHO_MAX
    return (mux.squeeze(-1), muy.squeeze(-1), sx.squeeze(-1),
            sy.squeeze(-1), rho.squeeze(-1))


def bivariate_gaussian_log_pdf(x, y, mux, muy, sx, sy, rho):
    """log N([x,y]; mu, Sigma) — log-domain version of reference tf_2d_normal
    (model/model.py:494-523). Equivalent math, no exp-underflow."""
    nx = (x - mux) / sx
    ny = (y - muy) / sy
    one_m_rho2 = 1.0 - rho * rho
    z = nx * nx + ny * ny - 2.0 * rho * nx * ny
    return (-z / (2.0 * one_m_rho2)
            - jnp.log(2.0 * jnp.pi)
            - jnp.log(sx) - jnp.log(sy)
            - 0.5 * jnp.log(one_m_rho2))


def bivariate_nll(raw, target_xy, step_mask=None, floor=True):
    """Per-element negative log-likelihood.

    raw:       (..., 5)   decoder outputs (pre-get_coef)
    target_xy: (..., 2)   ground-truth points
    step_mask: (...)      optional 0/1 validity per step
    Returns (...) NLL per step. Reference sums ``-log(max(pdf, 1e-20))``
    (model/model.py:544-550); with ``floor=True`` we cap the NLL at
    -log(1e-20) to match that semantics exactly.
    """
    mux, muy, sx, sy, rho = get_coef(raw)
    logp = bivariate_gaussian_log_pdf(
        target_xy[..., 0], target_xy[..., 1], mux, muy, sx, sy, rho)
    if floor:
        logp = jnp.maximum(logp, _LOG_PDF_FLOOR)
    nll = -logp
    if step_mask is not None:
        nll = nll * step_mask
    return nll


def kld_normal(mean, log_var, axis=-1, free_bits=0.0):
    """KL( N(mean, exp(log_var)) || N(0, I) ), summed over `axis`.

    Exactly the reference latent loss (model/model.py:587-589):
    ``-0.5 * sum(1 + log_var - mean^2 - exp(log_var))``.

    free_bits > 0 floors each dimension's KL contribution at that value
    before summing (Kingma et al. 2016) — dims already below the floor stop
    receiving KL gradient, which protects the latent from posterior collapse.
    """
    per_dim = -0.5 * (1.0 + log_var - jnp.square(mean) - jnp.exp(log_var))
    if free_bits > 0.0:
        per_dim = jnp.maximum(per_dim, free_bits)
    return jnp.sum(per_dim, axis=axis)


def kld_gaussians(mean_q, log_var_q, mean_p, log_var_p, axis=-1,
                  free_bits=0.0):
    """KL( N(mean_q, exp(log_var_q)) || N(mean_p, exp(log_var_p)) ), summed
    over `axis` — the conditional-prior generalization of kld_normal (reduces
    to it exactly at mean_p = log_var_p = 0; config.py cond_prior).

    free_bits floors each dimension's contribution like kld_normal."""
    var_q = jnp.exp(log_var_q)
    inv_var_p = jnp.exp(-log_var_p)
    per_dim = 0.5 * (log_var_p - log_var_q - 1.0
                     + (var_q + jnp.square(mean_q - mean_p)) * inv_var_p)
    if free_bits > 0.0:
        per_dim = jnp.maximum(per_dim, free_bits)
    return jnp.sum(per_dim, axis=axis)


def masked_mean(values, mask, eps=1e-8):
    """Mean of `values` over entries where mask!=0.

    Mirrors the reference's cost/counter accumulation (model/model.py:351-376):
    cost = sum(loss * live) / count(live).
    """
    mask = mask.astype(values.dtype)
    total = jnp.sum(values * mask)
    count = jnp.sum(mask)
    return total / jnp.maximum(count, eps)


def agent_validity_mask(src_ids, tgt_ids=None):
    """Live-agent mask: id==0 marks an empty slot (reference
    model/model.py:204-206,355-366 — an agent must exist in both the source
    and the target frames to contribute)."""
    live = src_ids != 0
    if tgt_ids is not None:
        live = jnp.logical_and(live, tgt_ids != 0)
    return live.astype(jnp.float32)


# ---------------------------------------------------------------------------
# IOC losses (DESIRE paper eq. 5-7; no reference implementation exists)
# ---------------------------------------------------------------------------

def ioc_cross_entropy(scores, hyp_xy, gt_xy, agent_mask, step_mask=None,
                      temperature=1.0, standardize=True):
    """Max-ent IOC ranking loss over K hypotheses.

    scores:   (..., K)        accumulated per-hypothesis scores (higher=better)
    hyp_xy:   (..., K, T, 2)  hypothesis trajectories
    gt_xy:    (..., T, 2)     ground truth future
    agent_mask: (...)         live-agent mask
    step_mask:  (..., T)      optional per-step validity

    Target distribution q_k ∝ exp(-dist_k / temperature) where dist_k is the
    mean displacement error of hypothesis k; loss = CE(q, softmax(scores)),
    masked-mean over agents.

    standardize=True (default) z-scores the distances across the K lanes
    per agent before the softmax, making the target's sharpness scale-FREE.
    Without it the target collapses to uniform whenever the lane-distance
    spread is small relative to `temperature` in absolute units — measured
    in round 2: with raw distances (~0.01-0.05 normalized-unit spreads) and
    temp 0.05 the train CE sat exactly at ln(K) for 30 epochs, i.e. the
    ranking head received no usable gradient and top-1 selection stayed at
    chance. On standardized distances `temperature` means "softness in units
    of the per-agent lane spread" (0.5 -> the best lane gets ~e^2x the mass
    of a +1-sigma lane, regardless of scene scale or training stage).
    """
    # The distance-derived target q is a TARGET: stop_gradient, or the CE
    # backprops into the trajectories and moves them to make the distances
    # match the (initially uniform) scores — measured to drag refined
    # hypotheses ~100px AWAY from ground truth. Only the scores side learns.
    hyp_xy = jax.lax.stop_gradient(hyp_xy)
    diff = hyp_xy - gt_xy[..., None, :, :]
    # eps-guarded norm: plain L2 has a NaN gradient at exactly-zero distance,
    # which dead (masked) agents hit (hypothesis == GT == origin).
    d = jnp.sqrt(jnp.sum(diff * diff, axis=-1) + 1e-12)            # (..., K, T)
    if step_mask is not None:
        sm = step_mask[..., None, :]
        d = jnp.sum(d * sm, axis=-1) / jnp.maximum(jnp.sum(sm, axis=-1), 1e-8)
    else:
        d = jnp.mean(d, axis=-1)                                   # (..., K)
    if standardize:
        mu = jnp.mean(d, axis=-1, keepdims=True)
        sd = jnp.std(d, axis=-1, keepdims=True)
        d = (d - mu) / (sd + 1e-8)
    q = jax.nn.softmax(-d / temperature, axis=-1)
    logp = jax.nn.log_softmax(scores, axis=-1)
    ce = -jnp.sum(q * logp, axis=-1)                               # (...)
    return masked_mean(ce, agent_mask)


def refine_regression_loss(refined_xy, gt_xy, agent_mask, step_mask=None,
                           agg="min", lane_penalty=None):
    """L2 regression on refined trajectories.

    refined_xy: (..., K, T, 2); gt_xy: (..., T, 2). agg over the K lanes:
    'min' (default) trains only the closest refined hypothesis toward GT —
    refinement sharpens the best mode without collapsing the others onto the
    conditional mean; 'mean' is the paper's regress-every-sample term.
    lane_penalty: optional (..., K) additive penalty applied before the min —
    the variety-subset hook (config.py variety_k): +1e9 on excluded lanes
    restricts the min to the chosen subset.
    """
    err = jnp.sum(jnp.square(refined_xy - gt_xy[..., None, :, :]), axis=-1)
    if step_mask is not None:
        sm = step_mask[..., None, :]
        err = jnp.sum(err * sm, axis=-1) / jnp.maximum(jnp.sum(sm, axis=-1), 1e-8)
    else:
        err = jnp.mean(err, axis=-1)
    if agg == "min":
        if lane_penalty is not None:
            err = err + lane_penalty
        err = jnp.min(err, axis=-1)
    else:
        err = jnp.mean(err, axis=-1)
    return masked_mean(err, agent_mask)


def sample_bivariate(raw, key):
    """Draw (x, y) from the bivariate Gaussian parameterized by raw (..., 5).

    Vectorized counterpart of reference ``sample_gaussian_2d``
    (model/model.py:595-611), vectorized over all leading dims with a
    counter-based PRNG instead of np.random.
    """
    mux, muy, sx, sy, rho = get_coef(raw)
    k1, k2 = jax.random.split(key)
    e1 = jax.random.normal(k1, mux.shape, dtype=mux.dtype)
    e2 = jax.random.normal(k2, muy.shape, dtype=muy.dtype)
    # Cholesky of [[sx^2, rho sx sy], [rho sx sy, sy^2]]
    x = mux + sx * e1
    y = muy + sy * (rho * e1 + jnp.sqrt(1.0 - rho * rho) * e2)
    return jnp.stack([x, y], axis=-1)
