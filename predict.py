#!/usr/bin/env python
"""Forecasting entry point — observations in, ranked future trajectories out.

The serving counterpart of evaluate.py (which needs ground-truth futures to
score metrics). Two modes:

File mode — forecast at the trailing edge of an SDD annotation CSV
(the reference's transposed 4-row layout, scripts/preprocess.py:31-34):

  python predict.py --save_dir save/flagship \\
      --csv /root/reference/data/coupa/video0/annotations_processed.csv

Stream mode — long-lived server; one JSON frame per stdin line
({"frame": N, "agents": [[id, x, y], ...]}, raw pixels), one JSON forecast
per stdout line once enough history has accumulated:

  python predict.py --save_dir save/flagship --stream --scale 1409

Latency statistics (post-warmup p50/p95 per dispatch) are printed to stderr
on exit.
"""

import argparse
import json
import sys

import numpy as np

from desire.data.loader import _native_or_python_reader
from desire.data.windows import build_video_index, materialize_window
from desire.serve import Predictor, StreamServer, forecast_to_json


def file_mode(args, pred: Predictor):
    reader = _native_or_python_reader(use_native=True)
    cfg = pred.cfg
    subsample = cfg.subsample if cfg.protocol == "paper" else 1
    for path in args.csv:
        frames, ids, xs, ys = reader(path)
        v = build_video_index(path, frames, ids, np.stack([xs, ys], -1),
                              subsample=subsample, normalize=cfg.normalize)
        # v.scale is the training-time per-video normalization (1.0 when the
        # checkpoint trained unnormalized — the model then wants raw pixels)
        scale = v.scale
        # the window ENDS at --at_step (default: the last indexed step)
        at = args.at_step if args.at_step >= 0 else v.num_steps - 1
        start = at - pred.obs_len + 1
        if start < 0:
            print(f"skip {path}: only {at + 1} steps at/<= requested "
                  f"step, need {pred.obs_len}", file=sys.stderr)
            continue
        # observation-only materialization: total_len = obs_len (no future
        # records consulted — this is a forecast, not an eval window)
        xy, mask, wids = materialize_window(
            v, start, pred.obs_len, pred.obs_len, cfg.max_num_obj,
            require_full_obs=cfg.protocol == "paper")
        scene_img = None
        if cfg.scene_image_channels > 0 and \
                cfg.scene_image_source == "occupancy":
            # the training-time scene raster for this video (the aggregate
            # occupancy prior the loader builds; loader._video_raster)
            from desire.data.windows import occupancy_prior
            scene_img = occupancy_prior(v, cfg.scene_grid)
        out = pred.predict(np.swapaxes(xy, 0, 1) * scale,
                           np.swapaxes(mask, 0, 1), wids, scale=scale,
                           scene_image=scene_img)
        out["frame"] = at * subsample
        out["step"] = at
        rec = json.loads(forecast_to_json(out, top_k=args.top_k))
        rec["video"] = path
        rec["scale"] = round(float(scale), 2)
        print(json.dumps(rec))


def stream_mode(args, pred: Predictor):
    if not args.scale:
        raise SystemExit("--stream requires --scale (the per-scene "
                         "pixels-per-unit the checkpoint trained with)")
    server = StreamServer(pred, scale=args.scale)
    pred.warmup()
    print(json.dumps({"ready": True, "obs_len": pred.obs_len,
                      "pred_len": pred.pred_len,
                      "subsample": server.subsample}), flush=True)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        msg = json.loads(line)
        out = server.observe(msg["frame"], msg.get("agents", ()))
        if out is not None:
            print(forecast_to_json(out, top_k=args.top_k), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--save_dir", required=True,
                    help="checkpoint directory (train.py --save_dir)")
    ap.add_argument("--csv", nargs="*", default=[],
                    help="SDD annotations_processed.csv file(s) to forecast")
    ap.add_argument("--stream", action="store_true",
                    help="JSONL frame feed on stdin -> forecasts on stdout")
    ap.add_argument("--at_step", type=int, default=-1,
                    help="sampled step the observation window ends at "
                         "(default: last)")
    ap.add_argument("--num_samples", type=int, default=0,
                    help="hypotheses K (default: checkpoint num_samples)")
    ap.add_argument("--top_k", type=int, default=5,
                    help="hypotheses emitted per agent, by score (0 = all)")
    ap.add_argument("--scale", type=float, default=0.0,
                    help="pixels-per-unit normalization (stream mode; file "
                         "mode derives it from the CSV like training did)")
    ap.add_argument("--max_windows", type=int, default=8,
                    help="compiled batch capacity")
    ap.add_argument("--best", type=int, default=0,
                    help="load save_dir/best instead of the latest")
    args = ap.parse_args(argv)
    if not args.csv and not args.stream:
        raise SystemExit("nothing to do: pass --csv file(s) or --stream")

    pred = Predictor(args.save_dir, k_samples=args.num_samples or None,
                     max_windows=args.max_windows, best=bool(args.best))
    try:
        if args.csv:
            file_mode(args, pred)
        if args.stream:
            stream_mode(args, pred)
    finally:
        print(json.dumps(pred.stats()), file=sys.stderr)


if __name__ == "__main__":
    main()
