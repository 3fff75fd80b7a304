#!/usr/bin/env python
"""Serving-latency benchmark: the FULL deployment path, not just the device
step — host window assembly, padding, H2D transfer, jitted forward (SGM draw
+ IOC rank/refine), D2H fetch of the ranked trajectories.

Prints one JSON line with p50/p95 per-dispatch latency and windows/sec at
flagship shapes (A=60 agents, K=20, 8 obs / 12 pred). Run with a trained
checkpoint (--save_dir) or --random_params for a shape-only measurement.

bench.py measures the jitted forward alone (blocked on the device result);
the delta between the two is the host-side serving overhead a deployment
actually pays per request.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--save_dir", default="")
    ap.add_argument("--random_params", type=int, default=0)
    ap.add_argument("--num_samples", type=int, default=20)
    ap.add_argument("--max_windows", type=int, default=8)
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--agents", type=int, default=60)
    ap.add_argument("--platform", default="")
    args = ap.parse_args(argv)

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from desire.config import DesireConfig
    from desire.models.desire import init_desire
    from desire.serve import Predictor

    if args.random_params or not args.save_dir:
        cfg = DesireConfig(max_num_obj=args.agents)
        params = init_desire(jax.random.PRNGKey(0), cfg)
        pred = Predictor(params=params, cfg=cfg,
                         k_samples=args.num_samples,
                         max_windows=args.max_windows)
    else:
        pred = Predictor(args.save_dir, k_samples=args.num_samples,
                         max_windows=args.max_windows)
    pred.warmup()

    rng = np.random.RandomState(0)
    to, a = pred.obs_len, pred.cfg.max_num_obj
    windows = []
    for _ in range(args.max_windows):
        p0 = rng.uniform(100, 900, (a, 2)).astype(np.float32)
        v = rng.uniform(-40, 40, (a, 2)).astype(np.float32)
        t = np.arange(to, dtype=np.float32)[None, :, None]
        windows.append((p0[:, None] + v[:, None] * t,
                        np.ones((a, to), np.float32),
                        np.arange(1, a + 1, dtype=np.int64)))
    for _ in range(args.iters):
        pred.predict_windows(windows, scales=1000.0)
    s = pred.stats()
    s.update(metric="serve_latency", unit="ms/dispatch",
             windows_per_dispatch=args.max_windows,
             agents=a, k=pred.k,
             agent_forecasts_per_sec=round(
                 s["windows_per_sec"] * args.max_windows * a))
    print(json.dumps(s))


if __name__ == "__main__":
    main()
