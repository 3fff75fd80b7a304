"""The full DESIRE model: SGM (CVAE sampler) + SCF + IOC rank-and-refine.

Assembles the capability spec of SURVEY §7.1: K-hypothesis CVAE sample
generation (reference C3-C12), scene-context feature pooling rebuilt from the
paper (C13 was a stand-in), the IOC module the reference never implemented,
and the masked multi-task loss (C14-C16 semantics + the paper's IOC terms).

Batch convention (from desire.data.loader.Batch):
  xy   (B, T, A, 2)   T = obs_len + pred_len (paper) / seq+1 (compat)
  mask (B, T, A)
  ids  (B, A)

The model flattens agents into rows (N = B*A) for all per-agent compute and
keeps (B, A) structure only where interaction requires it (SCF).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from desire.config import DesireConfig
from desire.models import ioc as ioc_mod
from desire.models import layers as L
from desire.models import losses
from desire.models import scf as scf_mod
from desire.models import sgm as sgm_mod
from desire.parallel.sharding import shard_hint


def init_desire(key, cfg: DesireConfig, dtype=jnp.float32) -> dict:
    k1, k2, k3 = jax.random.split(key, 3)
    params = {"sgm": sgm_mod.init_sgm(k1, cfg, dtype)}
    if cfg.use_scf or cfg.use_ioc:
        params["scf"] = scf_mod.init_scf(k2, cfg, dtype)
    if cfg.use_ioc:
        params["ioc"] = ioc_mod.init_ioc(k3, cfg, dtype)
    return params


def split_batch(cfg: DesireConfig, xy, mask):
    """(B,T,A,·) -> obs/future, agent-major."""
    to = cfg.obs_len if cfg.protocol == "paper" else cfg.seq_length
    obs_xy = jnp.swapaxes(xy[:, :to], 1, 2)       # (B, A, To, 2)
    fut_xy = jnp.swapaxes(xy[:, to:], 1, 2)       # (B, A, Tf, 2)
    obs_mask = jnp.swapaxes(mask[:, :to], 1, 2)   # (B, A, To)
    fut_mask = jnp.swapaxes(mask[:, to:], 1, 2)   # (B, A, Tf)
    return obs_xy, fut_xy, obs_mask, fut_mask


def desire_forward(params, cfg: DesireConfig, xy, mask, ids, *, key,
                   k_samples=None, train=True, z_temp=None,
                   scene_image=None):
    """End-to-end forward. Returns a dict of all stage outputs.

    z_temp: optional (B, A) per-agent latent sampling temperature
    (inference-only eval knob; see sgm_forward).
    scene_image: optional (B, G, G, cfg.scene_image_channels) imagery
    raster for the scene CNN (models/scf.py); zeros when the config
    declares imagery channels but the batch carries none."""
    K = k_samples or cfg.num_samples
    # geometry (positions, masks, targets) stays f32 — bf16 quantizes [0,1]
    # coords by ~1-4 px at SDD scale, biasing both training targets and the
    # reported pixel metrics; only network-internal activations run in
    # compute_dtype (cast inside sgm/scf/ioc at the embedding boundaries)
    xy = shard_hint(xy.astype(jnp.float32), "data")
    mask = shard_hint(mask.astype(jnp.float32), "data")

    b, _, a, _ = xy.shape
    obs_xy, fut_xy, obs_mask, fut_mask = split_batch(cfg, xy, mask)
    live = losses.agent_validity_mask(ids)                        # (B, A)

    n = b * a
    out = sgm_mod.sgm_forward(
        params["sgm"], cfg,
        obs_xy.reshape(n, *obs_xy.shape[2:]),
        obs_mask.reshape(n, -1),
        fut_xy.reshape(n, *fut_xy.shape[2:]) if train else None,
        fut_mask.reshape(n, -1) if train else None,
        key=key, k_samples=K, train=train,
        z_temp=(None if z_temp is None
                else z_temp.reshape(n, 1, 1).astype(jnp.float32)))

    tf_len = fut_xy.shape[2]
    traj = out["traj_mu"].reshape(b, a, K, tf_len, 2)
    dec_h = out["dec_h"].reshape(b, a, K, tf_len, -1)

    result = {
        "raw5": out["raw5"].reshape(b, a, K, tf_len, 5),
        "sgm_traj": traj,
        "z_mu": None if out["z_mu"] is None else out["z_mu"].reshape(b, a, -1),
        "z_logvar": (None if out["z_logvar"] is None
                     else out["z_logvar"].reshape(b, a, -1)),
        "zp_mu": (None if out["zp_mu"] is None
                  else out["zp_mu"].reshape(b, a, -1)),
        "zp_logvar": (None if out["zp_logvar"] is None
                      else out["zp_logvar"].reshape(b, a, -1)),
        "live": live,
        "obs_xy": obs_xy, "fut_xy": fut_xy,
        "obs_mask": obs_mask, "fut_mask": fut_mask,
    }

    if cfg.use_ioc:
        if cfg.use_scf:
            if cfg.scene_image_channels and scene_image is None:
                scene_image = jnp.zeros(
                    (b, cfg.scene_grid, cfg.scene_grid,
                     cfg.scene_image_channels), jnp.float32)
            feat_map = scf_mod.scene_feature_map(
                params["scf"], jnp.swapaxes(obs_xy, 1, 2),
                jnp.swapaxes(obs_mask, 1, 2), cfg.scene_grid,
                compute_dtype=cfg.compute_dtype,
                image=scene_image if cfg.scene_image_channels else None)
        else:
            # use_scf=False with IOC on: rank/refine from dynamics + social
            # context only — a zero scene map keeps the fusion layout stable
            # while actually disabling scene-context features (ADVICE r1)
            cd = jnp.bfloat16 if cfg.compute_dtype == "bfloat16" else jnp.float32
            feat_map = jnp.zeros(
                (b, cfg.scene_grid, cfg.scene_grid, cfg.scene_channels), cd)
        refined, scores, per_iter = ioc_mod.ioc_forward(
            params["ioc"], params["scf"], cfg, traj, dec_h, feat_map,
            live, fut_mask)
        result.update(refined_traj=refined, scores=scores,
                      per_iter_trajs=per_iter)
    else:
        result.update(refined_traj=traj, scores=None, per_iter_trajs=[])
    return result


def desire_loss(params, cfg: DesireConfig, xy, mask, ids, *, key, step=None,
                k_samples=None, scene_image=None):
    """Multi-task training loss + metrics.

    NLL term: per the reference semantics (C14/C16) the bivariate NLL is
    summed over prediction steps and masked-averaged over live agents.
    Aggregation over the K lanes follows cfg.recon_agg: 'mean' trains every
    CVAE sample toward the ground truth (the paper's CVAE term); 'min'
    (default) is the best-of-K / variety loss — only the closest lane pays,
    which directly optimizes the minADE@K headline metric and structurally
    resists hypothesis collapse.
    """
    key, k_lanes = jax.random.split(key)
    out = desire_forward(params, cfg, xy, mask, ids, key=key,
                         k_samples=k_samples, train=True,
                         scene_image=scene_image)
    fut_xy, fut_mask, live = out["fut_xy"], out["fut_mask"], out["live"]
    f32 = jnp.float32
    # loss mask: an agent must have at least one valid future step —
    # otherwise its zero NLL dilutes the masked mean and its zero distances
    # make the CE target uniform (reference C16 semantics: present in source
    # AND target, model/model.py:351-366)
    live = live * (jnp.sum(fut_mask, axis=-1) > 0).astype(live.dtype)

    if cfg.speed_loss_alpha > 0:
        # speed-balanced weighting (config.py speed_loss_alpha): scale the
        # live mask by (speed / batch-mean-speed)^alpha, renormalized to
        # mean 1 over live agents — masked_mean then computes a weighted
        # mean, so EVERY loss term below is class-balanced the same way
        s = sgm_mod.observed_speed(
            out["obs_xy"].reshape(-1, out["obs_xy"].shape[2], 2),
            out["obs_mask"].reshape(-1, out["obs_mask"].shape[2]))
        s = jax.lax.stop_gradient(s.reshape(live.shape))
        mean_s = losses.masked_mean(s, live)
        w = ((s + 1e-4) / (mean_s + 1e-4)) ** cfg.speed_loss_alpha
        w = w / jnp.maximum(losses.masked_mean(w, live), 1e-6)
        live = live * w

    # (B, A, K) step-summed NLL of ground truth under each lane's gaussians
    raw5 = out["raw5"].astype(f32)
    b, a, K, tf_len, _ = raw5.shape
    nll_steps = losses.bivariate_nll(
        raw5, fut_xy[:, :, None].astype(f32),
        step_mask=fut_mask[:, :, None].astype(f32))
    nll_per_lane = jnp.sum(nll_steps, axis=-1)            # sum over steps (C14)
    # variety-subset lanes (config.py variety_k): min-aggregated losses see
    # a random variety_k-lane subset per agent per step — the best-of-K
    # gradient stays as concentrated as small-K training while the ranking
    # CE below still trains on all K lanes. Implemented as a +1e9 penalty on
    # the excluded lanes before every min.
    lane_pen = None
    if cfg.recon_agg == "min" and 0 < cfg.variety_k < K:
        u = jax.random.uniform(k_lanes, (b, a, K))
        kth = jnp.sort(u, axis=-1)[..., cfg.variety_k - 1, None]
        lane_pen = jnp.where(u <= kth, 0.0, 1e9).astype(f32)   # (B, A, K)
    if cfg.recon_agg == "min":
        nll_agg = jnp.min(nll_per_lane if lane_pen is None
                          else nll_per_lane + lane_pen, axis=-1)
    else:
        nll_agg = jnp.mean(nll_per_lane, axis=-1)
    nll = losses.masked_mean(nll_agg, live)

    if out["zp_mu"] is not None:
        # conditional prior p(z|X): KL(q(z|X,Y) || p(z|X)) (cond_prior)
        kld_per = losses.kld_gaussians(
            out["z_mu"].astype(f32), out["z_logvar"].astype(f32),
            out["zp_mu"].astype(f32), out["zp_logvar"].astype(f32),
            free_bits=cfg.kld_free_bits)
    else:
        kld_per = losses.kld_normal(
            out["z_mu"].astype(f32), out["z_logvar"].astype(f32),
            free_bits=cfg.kld_free_bits)
    kld = losses.masked_mean(kld_per, live)
    w_kld = cfg.w_kld
    if cfg.kld_warmup and step is not None:
        w_kld = w_kld * jnp.clip(step / cfg.kld_warmup, 0.0, 1.0)

    total = cfg.w_nll * nll + w_kld * kld
    metrics = {"nll": nll, "kld": kld}

    kp = int(round(K * cfg.prior_lane_frac))
    if kp > 0 and cfg.w_prior_nll > 0:
        # prior-predictive coverage (config.py w_prior_nll): best-of-the-
        # kp-prior-lanes NLL. nll_per_lane is already computed for all K
        # lanes, so the term costs one masked min. No variety subsetting —
        # kp is small and this IS the diversity objective.
        nll_prior = losses.masked_mean(
            jnp.min(nll_per_lane[..., :kp], axis=-1), live)
        total = total + cfg.w_prior_nll * nll_prior
        metrics["prior_nll"] = nll_prior

    if cfg.use_ioc:
        scores = out["scores"].astype(f32)
        live_t = live.astype(f32)
        ce = losses.ioc_cross_entropy(
            scores, out["refined_traj"].astype(f32), fut_xy.astype(f32),
            live_t, step_mask=fut_mask.astype(f32), temperature=cfg.ioc_temp)
        reg = 0.0
        for t in out["per_iter_trajs"]:
            reg = reg + losses.refine_regression_loss(
                t.astype(f32), fut_xy.astype(f32), live_t,
                step_mask=fut_mask.astype(f32), agg=cfg.recon_agg,
                lane_penalty=lane_pen)
        reg = reg / max(len(out["per_iter_trajs"]), 1)
        # trust region: keep every lane's refinement near its SGM hypothesis
        delta2 = jnp.sum(jnp.square(out["refined_traj"].astype(f32)
                                    - out["sgm_traj"].astype(f32)), axis=-1)
        delta2 = delta2 * fut_mask[:, :, None].astype(f32)
        delta_mag = losses.masked_mean(jnp.mean(delta2, axis=(-1, -2)), live_t)
        total = total + cfg.w_ce * ce + cfg.w_reg * reg + cfg.w_delta * delta_mag
        metrics.update(ioc_ce=ce, refine_reg=reg, delta_mag=delta_mag)

    metrics["loss"] = total
    return total, metrics
