#!/usr/bin/env python
"""Evaluation / sampling entry point — replaces the reference's tryout.py
scratch script (SURVEY §7.1 item 8) with a real harness: best-of-K
minADE/minFDE @4.8s in pixels, IOC top-1 metrics, and trajectory dumps.

Examples:
  python evaluate.py --save_dir save/ --data_dir /root/reference/data \
      --scenes coupa --num_samples 20
  python evaluate.py --random_params 1 --scenes bookstore   # smoke, no ckpt
"""

import argparse
import json
import os
import sys

import jax

from desire.config import DesireConfig, add_config_flags, config_from_args
from desire.data.loader import SDDLoader
from desire.eval.sampler import evaluate
from desire.models.desire import init_desire
from desire.train import checkpoint as ckpt_mod
from desire.train.state import create_train_state


# model-geometry fields: restored from the checkpoint config unless the flag
# is explicitly passed on the command line (sentinel-default argparse — an
# explicit flag equal to the dataclass default still wins, ADVICE r1).
# The field list lives next to the checkpoint code (one source for every
# restoring entry point: this, serve.Predictor).
_GEOMETRY_FIELDS = ckpt_mod.GEOMETRY_FIELDS


def main(argv=None):
    from desire.utils.logging import enable_compile_cache
    enable_compile_cache()
    parser = argparse.ArgumentParser(description=__doc__)
    add_config_flags(parser)
    parser.set_defaults(**{f: None for f in _GEOMETRY_FIELDS})
    parser.add_argument("--split", type=str, default="heldout",
                        choices=("heldout", "train", "all"),
                        help="which side of the holdout partition to "
                             "evaluate (config.py holdout; 'all' or "
                             "holdout='none' = every video, the pre-round-3 "
                             "in-sample behavior)")
    parser.add_argument("--max_eval_batches", type=int, default=0,
                        help="0 = full epoch")
    parser.add_argument("--random_params", type=int, default=0,
                        help="skip checkpoint loading (smoke test)")
    parser.add_argument("--rank_blend", type=float, default=None,
                        help="top-1 selection: z(IOC score) + blend * "
                             "z(lane typicality); 0 = pure IOC score "
                             "(metrics.best_of_k_by_score). Default: the "
                             "train-split-fitted blend stored in the "
                             "checkpoint config (rank_blend_fit), else 0")
    parser.add_argument("--z_temp_fast", type=float, default=1.0,
                        help="latent sampling temperature for agents "
                             "observed faster than --z_temp_px (eval-time "
                             "fast-agent hypothesis spread; 1 = off)")
    parser.add_argument("--z_temp_px", type=float, default=20.0,
                        help="observed-speed threshold (px/step) above "
                             "which --z_temp_fast applies")
    parser.add_argument("--best", type=int, default=0,
                        help="load <save_dir>/best (the best-by-held-out-"
                             "minADE checkpoint train.py keeps) instead of "
                             "the latest")
    parser.add_argument("--per_scene", type=int, default=0,
                        help="add a per-scene metric breakdown")
    parser.add_argument("--horizons", type=str, default="",
                        help="comma-separated horizon seconds, e.g. "
                             "'1,2,3,4' — adds the DESIRE paper's SDD table "
                             "(errors per horizon, incl. 1/5-resolution px)")
    parser.add_argument("--calibration", type=int, default=0,
                        help="add PIT/coverage calibration statistics of the "
                             "gaussian heads")
    parser.add_argument("--calib_fit_batches", type=int, default=40,
                        help="with --calibration: fit a post-hoc "
                             "sigma-temperature on this many TRAIN-split "
                             "batches and report corrected coverage next to "
                             "the raw numbers (0 disables the fit)")
    parser.add_argument("--calib_two_param", type=int, default=1,
                        help="fit a (tau_center, tau_tail) two-scale "
                             "temperature (calibrates 50%% AND 90%% "
                             "coverage) instead of the scalar tau (which "
                             "trades the tails for the center)")
    parser.add_argument("--speed_bins", type=str, default="",
                        help="comma-separated px/step boundaries (e.g. "
                             "'2,8,20') — adds an observed-speed-class error "
                             "breakdown (bikes vs walkers)")
    parser.add_argument("--dump", type=str, default="",
                        help="write sampled trajectories to this .npz "
                             "(obs/fut/mask, all-K hypotheses, IOC scores, "
                             "ranked-best, per-window video id + px scale)")
    parser.add_argument("--dump_batches", type=int, default=4,
                        help="number of batches to dump")
    parser.add_argument("--platform", type=str, default="")
    args = parser.parse_args(argv)
    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    explicit = {f: getattr(args, f) for f in _GEOMETRY_FIELDS
                if getattr(args, f) is not None}
    for f in _GEOMETRY_FIELDS:  # resolve sentinels before building the config
        setattr(args, f, explicit.get(f, getattr(DesireConfig, f)))
    cfg = config_from_args(args)
    saved_cfg = None
    if cfg.save_dir:
        if args.best:
            # best/ carries its own config (train.py's final selection
            # writes the fitted rank blend there) — prefer it
            saved_cfg = ckpt_mod.load_config(
                os.path.join(cfg.save_dir, "best"))
        if saved_cfg is None:
            saved_cfg = ckpt_mod.load_config(cfg.save_dir)
    if saved_cfg is not None and not args.random_params:
        # geometry comes from the checkpoint UNLESS explicitly flagged (e.g.
        # --num_refine 0 to eval the raw SGM hypotheses)
        cfg = ckpt_mod.overlay_geometry(cfg, saved_cfg, skip=explicit)

    split = None if (args.split == "all" or cfg.holdout == "none") \
        else args.split
    if split == "heldout":
        # held-out eval uses the wider eval hop (less window overlap) unless
        # the user explicitly set window_hop
        passed = {a.split("=")[0].lstrip("-") for a in (argv or sys.argv[1:])}
        if "window_hop" not in passed:
            cfg = cfg.replace(window_hop=cfg.eval_hop)
    loader = SDDLoader(cfg, split=split, drop_remainder=False)
    print(json.dumps({"split": args.split if split else "all",
                      "videos": [v.name for v in loader.videos],
                      "windows": loader.num_windows,
                      "window_hop": cfg.window_hop}))
    params = init_desire(jax.random.PRNGKey(cfg.seed), cfg)
    if not args.random_params:
        state = create_train_state(cfg, params, loader.num_batches)
        ckpt_dir = os.path.join(cfg.save_dir, "best") if args.best \
            else cfg.save_dir
        mgr = ckpt_mod.CheckpointManager(ckpt_dir)
        got = mgr.restore(state)
        if got is None:
            raise SystemExit(f"no checkpoint found in {ckpt_dir}")
        params = got[0].params

    if args.dump:
        from desire.eval.sampler import dump_trajectories
        n = dump_trajectories(params, cfg, loader, args.dump,
                              num_batches=args.dump_batches)
        print(json.dumps({"dumped": args.dump, "windows": n}))

    horizons = tuple(float(h) for h in args.horizons.split(",") if h.strip())
    speed_bins = tuple(float(s) for s in args.speed_bins.split(",")
                       if s.strip())

    sigma_temps = (1.0,)
    fit_diag = None
    if args.calibration and args.calib_fit_batches > 0:
        # post-hoc sigma-temperature: fit on a TRAIN-video validation slice
        # (never the split being reported), then report exact corrected
        # coverage at that tau next to the raw numbers
        from desire.eval.sampler import fit_sigma_temperature
        if cfg.holdout == "none":
            # no disjoint split exists — fitting here would be in-sample on
            # the exact data being reported; skip and say so (ADVICE r4)
            fit_diag = {"skipped": "holdout='none': no disjoint fit split"}
        else:
            fit_split = "train"
            fit_loader = loader if (split == fit_split) else SDDLoader(
                cfg, split=fit_split, drop_remainder=False)
            tau, fit_diag = fit_sigma_temperature(
                params, cfg, fit_loader, max_batches=args.calib_fit_batches,
                two_param=bool(args.calib_two_param))
            sigma_temps = (1.0, tau)

    # --rank_blend unset -> the train-split-fitted blend persisted in the
    # checkpoint config (train.py final selection), else pure IOC score
    rank_blend = (args.rank_blend if args.rank_blend is not None
                  else max(cfg.rank_blend_fit, 0.0))
    result = evaluate(params, cfg, loader,
                      max_batches=args.max_eval_batches or None,
                      per_scene=bool(args.per_scene),
                      horizons=horizons or None,
                      calibration=bool(args.calibration),
                      speed_bins=speed_bins or None,
                      rank_blend=rank_blend,
                      z_temp_fast=args.z_temp_fast,
                      z_temp_px=args.z_temp_px,
                      sigma_temps=sigma_temps)
    if fit_diag is not None:
        result.setdefault("calibration", {})["sigma_fit"] = fit_diag
    if rank_blend:
        result["rank_blend"] = rank_blend
    if args.z_temp_fast != 1.0:
        result["z_temp"] = {"fast": args.z_temp_fast, "px": args.z_temp_px}
    print(json.dumps(result, sort_keys=True))
    return result


if __name__ == "__main__":
    main()
