#!/usr/bin/env python
"""Train-step timing ladder: where does the flagship (B=64 A=60 K=20) train
step's time go?

Times the full jitted train step under config variants that each remove or
swap one stage, on the GPU, with bench.py's timing (block_until_ready).
Prints one JSON line per variant to stdout.

Usage: python scripts/train_breakdown.py [--iters 10]
"""

import argparse
import json
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax  # noqa: E402

import bench  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=3)
    args = ap.parse_args()

    from desire.utils.logging import enable_compile_cache
    enable_compile_cache()
    dev = bench.device_record()

    variants = [
        # name, config overrides
        ("full", {}),                              # the default recipe
        ("full_remat", {"remat": True}),
        ("no_ioc", {"use_ioc": False, "use_scf": False}),  # SGM+losses only
        ("no_social", {"use_social": False}),      # IOC minus social attn
        ("refine1", {"num_refine": 1}),            # 1 vs 4 IOC iterations
        ("K50_remat", {"num_samples": 50, "remat": True}),
    ]
    for name, kw in variants:
        try:
            cfg = bench.flagship_cfg(K=20).replace(**kw)
            steps_per_sec, dt, flops, nbytes = bench.bench_train(
                cfg, iters=args.iters, warmup=args.warmup)
            print(json.dumps({
                "variant": name, "train_step_ms": dt * 1e3,
                "steps_per_sec": steps_per_sec, "flops": flops,
                "bytes": nbytes, **dev}), flush=True)
        except Exception as e:  # keep the ladder going past one bad variant
            print(json.dumps({"variant": name,
                              "error": f"{type(e).__name__}: {e}"[:300]}),
                  flush=True)


if __name__ == "__main__":
    main()
