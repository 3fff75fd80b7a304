"""Inference-time sampling + the evaluation harness.

Vectorized counterpart of the reference ``DESIREModel.sample``
(/root/reference/model/model.py:613-688): instead of a Python loop of
per-step session.runs with numpy multivariate draws (hot loop #4, SURVEY
§3.5), one jitted forward produces all K hypotheses for every agent at once;
stochastic rollouts draw from the per-step bivariate Gaussians with a
counter-based PRNG inside the same program.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from desire.config import DesireConfig
from desire.eval import metrics as M
from desire.models import desire, losses
from desire.train.trainer import batch_to_device


def make_sampler(cfg: DesireConfig, k_samples=None, stochastic=False):
    """Returns jitted fn(params, xy, mask, ids, key) ->
    dict(traj (B,A,K,T,2), scores, best (B,A,T,2))."""
    def fn(params, xy, mask, ids, key, img=None):
        k1, k2 = jax.random.split(key)
        out = desire.desire_forward(params, cfg, xy, mask, ids, key=k1,
                                    k_samples=k_samples, train=False,
                                    scene_image=img)
        traj = out["refined_traj"]
        if stochastic:
            # draw positions from the SGM per-step gaussians, then re-apply
            # the IOC refinement deltas on top of the drawn means
            drawn = losses.sample_bivariate(out["raw5"].astype(jnp.float32), k2)
            traj = traj + (drawn - out["sgm_traj"])
        scores = out["scores"]
        if scores is None:
            scores = jnp.zeros(traj.shape[:3], traj.dtype)
        # ranked pick uses the train-slice-fitted blend when the checkpoint
        # carries one (config rank_blend_fit) — same default as evaluate.py
        best = M.best_of_k_by_score(traj, scores,
                                    blend=max(cfg.rank_blend_fit, 0.0))
        return {"traj": traj, "scores": scores, "best": best,
                "sgm_traj": out["sgm_traj"], "raw5": out["raw5"],
                "fut_mask": out["fut_mask"], "live": out["live"],
                "fut_xy": out["fut_xy"], "obs_xy": out["obs_xy"],
                "obs_mask": out["obs_mask"]}
    return jax.jit(fn)


def make_eval_step(cfg: DesireConfig, k_samples=None, horizon_steps=(),
                   calibration=False, pit_bins=20, rank_blend=0.0,
                   z_temp_fast=1.0, z_temp_px=20.0, sigma_temps=(1.0,)):
    """One jitted program: forward pass + EVERY per-batch eval metric.

    The previous eval loop issued ~15-20 metric dispatches per batch
    (per-scene loop, horizons, speed bins, calibration — all separate jit
    calls + scalar syncs). This fuses everything into a single dispatch
    returning small per-agent (B, A) arrays; host-side numpy does the
    scene/speed-bin grouping.
    """
    def fn(params, xy, mask, ids, key, scale, img=None):
        k1, _ = jax.random.split(key)   # same split as make_sampler
        zt = None
        if z_temp_fast != 1.0:
            # speed-conditional latent temperature (eval-time fast-agent
            # spread): agents observed faster than z_temp_px px/step sample
            # with sigma * z_temp_fast; everyone else is untouched
            oxy, _, om_, _ = desire.split_batch(
                cfg, xy.astype(jnp.float32), mask.astype(jnp.float32))
            om_ = om_.astype(jnp.float32)
            b_ = om_[..., 1:] * om_[..., :-1]
            dd = jnp.diff(oxy, axis=2)
            spd = (jnp.sum(jnp.linalg.norm(dd, axis=-1) * b_, -1)
                   / jnp.maximum(jnp.sum(b_, -1), 1e-6)) * scale[:, None]
            zt = jnp.where(spd >= z_temp_px, z_temp_fast, 1.0)
        out = desire.desire_forward(params, cfg, xy, mask, ids, key=k1,
                                    k_samples=k_samples, train=False,
                                    z_temp=zt, scene_image=img)
        traj = out["refined_traj"].astype(jnp.float32)
        scores = out["scores"]
        if scores is None:
            scores = jnp.zeros(traj.shape[:3], traj.dtype)
        scores = scores.astype(jnp.float32)
        best = M.best_of_k_by_score(traj, scores,
                                    blend=rank_blend)[:, :, None]
        gt = out["fut_xy"].astype(jnp.float32)
        sm = out["fut_mask"].astype(jnp.float32)
        # weight by the agents the metric actually averages over (live AND
        # has a valid future step) — weighting by bare live would bias the
        # batch aggregation whenever the ratio differs across batches
        live = (out["live"].astype(jnp.float32)
                * (jnp.sum(sm, axis=-1) > 0))
        res = {"valid": live}
        res["ade"], res["fde"] = M.per_agent_min_ade_fde(
            traj, gt, sm, scale=scale)
        res["top1_ade"], res["top1_fde"] = M.per_agent_min_ade_fde(
            best, gt, sm, scale=scale)
        res["sgm_ade"], res["sgm_fde"] = M.per_agent_min_ade_fde(
            out["sgm_traj"].astype(jnp.float32), gt, sm, scale=scale)
        res["rank_pct"], res["rank_corr"] = M.per_agent_ranking(
            scores, traj, gt, sm)
        res["along"], res["cross"], res["dec_w"] = M.track_decomposition(
            traj, gt, sm, scale=scale)
        # observed speed (px/step at the protocol rate) per agent
        om = out["obs_mask"].astype(jnp.float32)
        both = om[..., 1:] * om[..., :-1]
        dxy = jnp.diff(out["obs_xy"].astype(jnp.float32), axis=2)
        res["speed"] = (jnp.sum(jnp.linalg.norm(dxy, axis=-1) * both, -1)
                        / jnp.maximum(jnp.sum(both, -1), 1e-6)
                        ) * scale[:, None]
        for i, hs in enumerate(horizon_steps):
            ha, hf, cov = M.per_agent_horizon(traj, gt, sm, hs, scale=scale)
            ba, bf, _ = M.per_agent_horizon(best, gt, sm, hs, scale=scale)
            res[f"h{i}"] = (ha, hf, ba, bf, cov)
        if calibration:
            # per-sigma-temperature PIT stats (the extra temps are a cheap
            # erf sweep next to the forward pass; used by the post-hoc
            # temperature fit and the corrected-coverage report)
            for j, tau in enumerate(sigma_temps):
                u, w = M.pit_values(out["raw5"], gt, sm, live,
                                    sigma_temp=tau)
                suff = "" if j == 0 else f"_t{j}"
                res[f"pit_hist{suff}"] = M.pit_histogram(u, w, pit_bins)
                w2 = jnp.broadcast_to(w[..., None], w.shape + (2,))
                for lv, name in ((0.5, "cov_50"), (0.9, "cov_90")):
                    lo, hi = (1 - lv) / 2, (1 + lv) / 2
                    inside = jnp.logical_and(u >= lo, u <= hi)
                    res[f"{name}{suff}"] = jnp.sum(
                        inside.astype(jnp.float32) * w2)
                if j == 0:
                    res["cov_w"] = jnp.sum(w2)  # weights are tau-independent
        return res
    return jax.jit(fn)


# temperature grid for the post-hoc sigma fit: coverage@50 is monotone
# increasing in tau, so a coarse grid + linear interpolation pins the root.
# Extends to 0.1: the r4 flagship's fit clamped at 0.5 and then at 0.3
# (fit-slice coverage 0.534 / 0.516 at those edges, target 0.5 below) —
# mixture coverage is dominated by BETWEEN-lane spread, so it flattens as
# tau -> 0 toward a discrete-mixture floor near 0.51; the low grid points
# let the fit land on (or honestly clamp at) that floor.
_FIT_TEMPS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0, 1.15,
              1.3, 1.5)

# (tau_center, tau_tail, w_center) grid for the two-scale fit: each lane
# CDF becomes the mixture w*Phi(z/tc) + (1-w)*Phi(z/tt) (metrics.
# pit_values), so the 50% interval is governed mostly by (tc, w) and the
# 90% interval mostly by tt. The raw heads over-disperse the center
# (tc < 1 expected) while the scalar fit showed tails go thin under
# uniform shrinking (tt near or above 1 expected). The r5 on-chip fit at
# fixed w=0.5 clamped tc at the grid edge with center coverage floored
# ~0.54 (the tail component's own central mass): w is the degree of
# freedom that decouples the levels.
_FIT_PAIR_TC = (0.05, 0.1, 0.2, 0.45)
_FIT_PAIR_TT = (0.6, 0.8, 1.0, 1.3, 1.7)
_FIT_PAIR_W = (0.35, 0.5, 0.65, 0.8)
_FIT_PAIRS = tuple((tc, tt, w) for tc in _FIT_PAIR_TC
                   for tt in _FIT_PAIR_TT for w in _FIT_PAIR_W)


def fit_sigma_temperature(params, cfg: DesireConfig, loader, *,
                          max_batches=40, k_samples=None, key=None,
                          temps=None, target=0.5, two_param=False):
    """Post-hoc sigma-temperature fit (VERDICT r3 item 9 / r4 item 6).

    Runs the model over a *train-split* validation slice and measures
    central coverage of the K-lane mixture at each candidate temperature.

    Scalar mode (two_param=False): returns (tau, diagnostics) where tau is
    the linear-interpolated root of coverage@50(tau) = target. Coverage is
    monotone increasing in tau in expectation (larger sigma pulls PIT
    values toward 0.5); eval noise between adjacent grid points is removed
    with a running max before the root find (ADVICE r4) so the bracketing
    segment is well-defined. tau is clipped to the grid ends if the target
    is outside.

    Two-parameter mode (two_param=True): candidates are (tau_center,
    tau_tail) pairs — per-lane two-scale CDF mixtures (metrics.pit_values)
    — and the fit picks the grid pair minimizing the squared miss at BOTH
    levels, (cov@50 - 0.5)^2 + (cov@90 - 0.9)^2. This removes the scalar
    trade where fixing the over-dispersed center thins the 90% tails.

    The fitted tau is then applied to a held-out eval via
    ``evaluate(..., sigma_temps=(1.0, tau))`` so the corrected coverage is
    exact, not interpolated.
    """
    key = key if key is not None else jax.random.PRNGKey(cfg.seed + 3)
    if temps is None:
        temps = _FIT_PAIRS if two_param else _FIT_TEMPS
    step = make_eval_step(cfg, k_samples=k_samples, calibration=True,
                          sigma_temps=tuple(temps))
    cov = np.zeros(len(temps))
    cov90 = np.zeros(len(temps))
    n = 0.0
    for bi, batch in enumerate(loader.epoch_batches(0)):
        if bi >= max_batches:
            break
        xy, mask, ids, *img = batch_to_device(batch)
        key, sub = jax.random.split(key)
        res = jax.device_get(step(params, xy, mask, ids, sub,
                                  jnp.asarray(batch.scale), *img))
        for j in range(len(temps)):
            suff = "" if j == 0 else f"_t{j}"
            cov[j] += float(res[f"cov_50{suff}"])
            cov90[j] += float(res[f"cov_90{suff}"])
        n += float(res["cov_w"])
    cov = cov / max(n, 1e-8)
    cov90 = cov90 / max(n, 1e-8)
    if two_param:
        err = (cov - target) ** 2 + (cov90 - 0.9) ** 2
        j = int(np.argmin(err))
        tau = tuple(float(t) for t in temps[j])
        return tau, {"temps": [list(t) for t in temps],
                     "coverage_50": [float(c) for c in cov],
                     "coverage_90": [float(c) for c in cov90],
                     "fit_weight": float(n)}
    # enforce monotonicity (eval noise can locally unsort the grid), then
    # root-find by linear interpolation
    cov_m = np.maximum.accumulate(cov)
    if target <= cov_m[0]:
        tau = temps[0]
    elif target >= cov_m[-1]:
        tau = temps[-1]
    else:
        j = int(np.searchsorted(cov_m, target, side="right")) - 1
        f = (target - cov_m[j]) / max(cov_m[j + 1] - cov_m[j], 1e-8)
        tau = temps[j] + f * (temps[j + 1] - temps[j])
    return float(tau), {"temps": list(temps),
                        "coverage_50": [float(c) for c in cov],
                        "coverage_90": [float(c) for c in cov90],
                        "fit_weight": float(n)}


def fit_rank_blend(params, cfg: DesireConfig, loader, *,
                   blends=(0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
                   max_batches=30, k_samples=None, key=None):
    """Fit the top-1 score/typicality blend on a train-split slice
    (VERDICT r4 item 2: --rank_blend as a trained quantity).

    One jitted program computes the forward ONCE per batch and the
    blended-argmax top-1 ADE at every candidate blend (the blend math is a
    few (B, A, K) element ops — metrics.best_of_k_by_score); the argmin
    blend goes into the checkpoint config (rank_blend_fit) so eval/serving
    rank with it by default, no flag needed. Returns (blend, diagnostics).
    """
    key = key if key is not None else jax.random.PRNGKey(cfg.seed + 7)
    blends = tuple(float(b) for b in blends)

    def fn(params, xy, mask, ids, key, scale, img=None):
        k1, _ = jax.random.split(key)
        out = desire.desire_forward(params, cfg, xy, mask, ids, key=k1,
                                    k_samples=k_samples, train=False,
                                    scene_image=img)
        traj = out["refined_traj"].astype(jnp.float32)
        scores = out["scores"]
        if scores is None:
            scores = jnp.zeros(traj.shape[:3], traj.dtype)
        scores = scores.astype(jnp.float32)
        gt = out["fut_xy"].astype(jnp.float32)
        sm = out["fut_mask"].astype(jnp.float32)
        live = (out["live"].astype(jnp.float32)
                * (jnp.sum(sm, axis=-1) > 0))
        res = {"w": jnp.sum(live)}
        for j, bl in enumerate(blends):
            best = M.best_of_k_by_score(traj, scores, blend=bl)[:, :, None]
            ade, _ = M.per_agent_min_ade_fde(best, gt, sm, scale=scale)
            res[f"t1_{j}"] = jnp.sum(ade * live)
        return res

    step = jax.jit(fn)
    sums = np.zeros(len(blends))
    w = 0.0
    for bi, batch in enumerate(loader.epoch_batches(0)):
        if bi >= max_batches:
            break
        xy, mask, ids, *img = batch_to_device(batch)
        key, sub = jax.random.split(key)
        res = jax.device_get(step(params, xy, mask, ids, sub,
                                  jnp.asarray(batch.scale), *img))
        for j in range(len(blends)):
            sums[j] += float(res[f"t1_{j}"])
        w += float(res["w"])
    t1 = sums / max(w, 1e-8)
    j = int(np.argmin(t1))
    return blends[j], {"blends": list(blends),
                       "top1ADE_px": [float(x) for x in t1],
                       "fit_weight": float(w)}


def evaluate(params, cfg: DesireConfig, loader, *, k_samples=None,
             key=None, max_batches=None, epoch: int = 0,
             per_scene: bool = False, horizons=None,
             calibration: bool = False, speed_bins=None,
             rank_blend: float = 0.0, z_temp_fast: float = 1.0,
             z_temp_px: float = 20.0, sigma_temps=(1.0,)) -> dict:
    """minADE/minFDE (pixels) over a loader's epoch stream.

    per_scene=True adds a per-scene breakdown keyed by scene name.
    horizons: optional seconds tuple (e.g. (1,2,3,4)) — adds the DESIRE
    paper's SDD table protocol: errors at each horizon, both full-resolution
    pixels and the paper's 1/5-resolution pixels (BASELINE.md:26-29).
    calibration=True adds PIT/coverage statistics of the SGM gaussian heads
    (north-star "match in distribution" evidence).
    speed_bins: optional ascending px/step boundaries (e.g. (2, 8, 20)) —
    adds an error breakdown by observed-speed class (slow walkers vs bikes;
    the diagnostic axis for the bike-heavy deathCircle/little scenes).
    sigma_temps: PIT sigma temperatures; index 0 must be 1.0 (the raw
    report); a second entry (from fit_sigma_temperature on a train slice)
    adds corrected `*_cal` calibration keys."""
    key = key if key is not None else jax.random.PRNGKey(cfg.seed + 1)
    acc: dict = {}
    # protocol rate: SDD annotations are ~30 fps; subsample strides to the
    # paper's 2.5 Hz (config.py subsample=12)
    hz = 30.0 / max(cfg.subsample, 1)
    horizons = [h for h in (horizons or ())
                if h * hz <= cfg.pred_len + 1e-6]
    hor_acc = {h: [0.0, 0.0, 0.0, 0.0, 0.0] for h in horizons}
    pit_bins = 20
    sigma_temps = tuple(sigma_temps)
    nt = len(sigma_temps)
    cal_acc = {"hist": [np.zeros(pit_bins) for _ in range(nt)],
               "cov_n": 0.0,
               "cov": [{0.5: 0.0, 0.9: 0.0} for _ in range(nt)]}
    step = make_eval_step(cfg, k_samples=k_samples,
                          horizon_steps=tuple(h * hz for h in horizons),
                          calibration=calibration, pit_bins=pit_bins,
                          rank_blend=rank_blend, z_temp_fast=z_temp_fast,
                          z_temp_px=z_temp_px, sigma_temps=sigma_temps)

    dec_acc: dict = {}

    def add(tag, a, f, b_ade, n):
        d = acc.setdefault(tag, [0.0, 0.0, 0.0, 0.0])
        d[0] += a
        d[1] += f
        d[2] += b_ade
        d[3] += n

    def add_dec(tag, res, sel):
        # along/cross-track decomposition of the min-ADE lane (only steps
        # with a defined GT tangent count — dec_w gates agents with none)
        d = dec_acc.setdefault(tag, [0.0, 0.0, 0.0])
        wd = sel * res["dec_w"]
        d[0] += float(np.sum(res["along"] * wd))
        d[1] += float(np.sum(res["cross"] * wd))
        d[2] += float(np.sum(wd))

    for bi, batch in enumerate(loader.epoch_batches(epoch)):
        if max_batches is not None and bi >= max_batches:
            break
        xy, mask, ids, *img = batch_to_device(batch)
        key, sub = jax.random.split(key)
        res = jax.device_get(step(params, xy, mask, ids, sub,
                                  jnp.asarray(batch.scale), *img))
        w = res["valid"]                                  # (B, A) weights

        def wsum(x, wt=w):
            return float(np.sum(x * wt))

        add("__all__", wsum(res["ade"]), wsum(res["fde"]),
            wsum(res["top1_ade"]), float(np.sum(w)))
        add_dec("__all__", res, w)
        add("__sgm__", wsum(res["sgm_ade"]), wsum(res["sgm_fde"]),
            wsum(res["sgm_ade"]), float(np.sum(w)))
        add("__rank__", wsum(res["rank_pct"]), wsum(res["rank_corr"]),
            0.0, float(np.sum(w)))
        if per_scene:
            for vid in np.unique(batch.video):
                sel = w * (batch.video == vid)[:, None]
                scene = loader.videos[int(vid)].name.split("/")[0]
                add(scene, wsum(res["ade"], sel), wsum(res["fde"], sel),
                    wsum(res["top1_ade"], sel), float(np.sum(sel)))
        if speed_bins:
            edges = [0.0] + list(speed_bins) + [float("inf")]
            for lo, hi in zip(edges[:-1], edges[1:]):
                sel = w * (res["speed"] >= lo) * (res["speed"] < hi)
                n_s = float(np.sum(sel))
                if n_s == 0:
                    continue
                tag = f"speed[{lo:g},{hi:g})px/step"
                add(tag, wsum(res["ade"], sel), wsum(res["fde"], sel),
                    wsum(res["top1_ade"], sel), n_s)
                add_dec(tag, res, sel)
        for i, h in enumerate(horizons):
            ha, hf, ba, bf, cov = res[f"h{i}"]
            sel = w * cov
            d = hor_acc[h]
            d[0] += wsum(ha, sel)
            d[1] += wsum(hf, sel)
            d[2] += wsum(ba, sel)
            d[3] += wsum(bf, sel)
            d[4] += float(np.sum(sel))
        if calibration:
            for j in range(nt):
                suff = "" if j == 0 else f"_t{j}"
                cal_acc["hist"][j] += res[f"pit_hist{suff}"]
                cal_acc["cov"][j][0.5] += float(res[f"cov_50{suff}"])
                cal_acc["cov"][j][0.9] += float(res[f"cov_90{suff}"])
            cal_acc["cov_n"] += float(res["cov_w"])

    def summarize(d, tag=None):
        w = max(d[3], 1e-8)
        out = {"minADE_px": d[0] / w, "minFDE_px": d[1] / w,
               "top1ADE_px": d[2] / w, "num_agents": d[3]}
        dec = dec_acc.get(tag)
        if dec and dec[2] > 0:
            out["alongADE_px"] = dec[0] / dec[2]
            out["crossADE_px"] = dec[1] / dec[2]
        return out

    result = dict(summarize(acc.get("__all__", [0.0] * 4), "__all__"),
                  K=k_samples or cfg.num_samples)
    sgm = summarize(acc.get("__sgm__", [0.0] * 4))
    result["sgm_minADE_px"] = sgm["minADE_px"]
    result["sgm_minFDE_px"] = sgm["minFDE_px"]
    rank = acc.get("__rank__")
    if rank and rank[3] > 0:
        # chance top1 percentile = 0.5 - 0.5/K; corr 0 = no ranking signal
        result["rank_top1_pctile"] = rank[0] / rank[3]
        result["rank_score_corr"] = rank[1] / rank[3]
    if speed_bins:
        result["speed_classes"] = {k: summarize(v, k) for k, v in acc.items()
                                   if k.startswith("speed[")}
    if per_scene:
        result["per_scene"] = {
            k: summarize(v) for k, v in acc.items()
            if k not in ("__all__", "__sgm__", "__rank__")
            and not k.startswith("speed[")}
    if horizons:
        result["horizons"] = {}
        for h, d in hor_acc.items():
            if d[4] <= 0:
                continue
            w = d[4]
            result["horizons"][f"{h:.1f}s"] = {
                "minADE_px": d[0] / w, "minFDE_px": d[1] / w,
                "top1ADE_px": d[2] / w, "top1FDE_px": d[3] / w,
                # the DESIRE paper's SDD table is in pixels at 1/5 resolution
                "minADE_px_fifth": d[0] / w / 5.0,
                "minFDE_px_fifth": d[1] / w / 5.0,
                "num_agents": w,
            }
    if calibration:
        n = max(cal_acc["cov_n"], 1e-8)

        def cal_stats(j):
            p = cal_acc["hist"][j] / max(cal_acc["hist"][j].sum(), 1e-8)
            # Kolmogorov distance of the PIT empirical CDF from Uniform(0,1)
            ks = float(np.max(np.abs(np.cumsum(p) - np.linspace(
                1.0 / pit_bins, 1.0, pit_bins))))
            return p, ks

        p0, ks0 = cal_stats(0)
        result["calibration"] = {
            "pit_ks": ks0,
            "coverage_50": cal_acc["cov"][0][0.5] / n,
            "coverage_90": cal_acc["cov"][0][0.9] / n,
            "pit_hist": [float(x) for x in p0],
        }
        if nt > 1:
            # corrected report at the post-hoc fitted temperature (exact —
            # the step computed PIT at that tau, no interpolation)
            p1, ks1 = cal_stats(1)
            t1 = sigma_temps[1]
            result["calibration"].update({
                "sigma_temp": list(t1) if isinstance(t1, (tuple, list)) else t1,
                "pit_ks_cal": ks1,
                "coverage_50_cal": cal_acc["cov"][1][0.5] / n,
                "coverage_90_cal": cal_acc["cov"][1][0.9] / n,
            })
    return result


def dump_trajectories(params, cfg: DesireConfig, loader, path, *,
                      num_batches=4, k_samples=None, key=None) -> int:
    """Write sampled trajectories for downstream use/visualization to an
    .npz — the artifact the reference's ``DESIREModel.sample`` produced
    in-process (model/model.py:613-688) but never persisted.

    Arrays (N = num_batches * batch_size windows):
      obs_xy (N, A, To, 2), obs_mask (N, A, To), fut_xy (N, A, Tf, 2),
      fut_mask (N, A, Tf), traj (N, A, K, Tf, 2) all-K refined hypotheses,
      scores (N, A, K) IOC scores, best (N, A, Tf, 2) ranked pick,
      live (N, A), video (N,) loader video index, scale (N,) px/unit.
    Returns the number of windows written."""
    sampler = make_sampler(cfg, k_samples=k_samples)
    key = key if key is not None else jax.random.PRNGKey(cfg.seed + 2)
    acc: dict = {}
    for bi, batch in enumerate(loader.epoch_batches(0)):
        if bi >= num_batches:
            break
        xy, mask, ids, *img = batch_to_device(batch)
        key, sub = jax.random.split(key)
        out = sampler(params, xy, mask, ids, sub, *img)
        rec = {"obs_xy": out["obs_xy"], "obs_mask": out["obs_mask"],
               "fut_xy": out["fut_xy"], "fut_mask": out["fut_mask"],
               "traj": out["traj"], "scores": out["scores"],
               "best": out["best"], "live": out["live"],
               "video": batch.video, "scale": batch.scale}
        for k, v in rec.items():
            # cast float-like arrays (incl. bf16, which numpy would save as
            # a raw 2-byte void dtype) to f32 before np conversion
            if getattr(v, "dtype", None) is not None and v.dtype.kind not in "iub":
                v = jnp.asarray(v).astype(jnp.float32)
            acc.setdefault(k, []).append(np.asarray(v))
    if not acc:
        return 0
    np.savez_compressed(path, **{k: np.concatenate(v) for k, v in acc.items()})
    return int(sum(a.shape[0] for a in acc["obs_xy"]))


def make_rollout(cfg: DesireConfig, k_samples=None, stochastic=False):
    """Long-horizon autoregressive rollout — the capability analogue of the
    reference's ``DESIREModel.sample`` feed-back loop (model/model.py:643-685,
    which fed each predicted frame back as the next input): predict a
    ``pred_len`` chunk, append the top-ranked hypothesis to the observation
    window, slide, repeat.

    Returns jitted fn(params, obs_xy (B,A,To,2), obs_mask, ids, key,
    num_chunks) -> (B, A, To + num_chunks*pred_len, 2). num_chunks is static.
    """
    sampler_core = make_sampler(cfg, k_samples=k_samples,
                                stochastic=stochastic)

    def fn(params, obs_xy, obs_mask, ids, key, num_chunks=1):
        b, a, to, _ = obs_xy.shape
        tf_len = cfg.pred_len
        out = [obs_xy]
        cur_xy, cur_mask = obs_xy, obs_mask
        for _ in range(num_chunks):
            key, sub = jax.random.split(key)
            # assemble a (B, T, A, ·) batch with an empty future block
            xy = jnp.concatenate(
                [jnp.swapaxes(cur_xy, 1, 2),
                 jnp.zeros((b, tf_len, a), cur_xy.dtype)[..., None].repeat(2, -1)],
                axis=1)
            mask = jnp.concatenate(
                [jnp.swapaxes(cur_mask, 1, 2),
                 jnp.broadcast_to(cur_mask[:, :, -1:],
                                  (b, a, tf_len)).swapaxes(1, 2)], axis=1)
            res = sampler_core(params, xy, mask, ids, sub)
            best = res["best"].astype(cur_xy.dtype)        # (B, A, Tf, 2)
            out.append(best)
            # slide the window: keep the last To steps
            cur_xy = jnp.concatenate([cur_xy, best], axis=2)[:, :, -to:]
            cur_mask = jnp.concatenate(
                [cur_mask, jnp.broadcast_to(cur_mask[:, :, -1:],
                                            (b, a, tf_len))], axis=2)[:, :, -to:]
        return jnp.concatenate(out, axis=2)

    return jax.jit(fn, static_argnames=("num_chunks",))
