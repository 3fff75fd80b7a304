#!/usr/bin/env python
"""Headline benchmark: sampled trajectories/sec at K=20 on one NVIDIA GPU.

Runs the flagship full-DESIRE inference path (SGM prior sampling -> SCF ->
IOC 4+1-pass rank/refine) and the flagship training step, and prints ONE
JSON line:

  {"metric": ..., "value": N, "unit": "traj/s", "fwd_ms": ..., ...,
   "platform": "gpu", "device_kind": ..., "device_count": 1, "card": ...}

A trajectory = one K-lane hypothesis for one agent slot: value =
B * A * K / sec. Shapes follow the paper protocol (8 obs / 12 pred steps).

Timing: the host clock around `iters` calls that end in block_until_ready,
after `warmup` calls (compilation is not timed). FLOPs and bytes are XLA's
cost analysis of the compiled program that is timed; a Pallas kernel is an
opaque custom call to that analysis, so its own work is not in the count.
mfu and hbm_frac divide them by the card's published peaks (PEAKS).

The benchmark needs a GPU: on any other backend, or on a GPU missing from
PEAKS, it raises instead of printing a number.

  python bench.py            # the one JSON line
  python bench.py --stages   # one JSON line per model stage (see stages())
"""

import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp

# device_kind -> (dense bf16 tensor-core FLOP/s, device-memory bytes/s).
# Source: NVIDIA H100 Tensor Core GPU data sheet (dense rates, without
# sparsity; SXM5 and PCIe parts).
PEAKS = {
    "NVIDIA H100 80GB HBM3": (989e12, 3.35e12),
    "NVIDIA H100 PCIe": (756e12, 2.0e12),
}


def device_record() -> dict:
    """The device every number is taken on; raises off the GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"bench.py measures a GPU; the JAX backend is "
                           f"{dev.platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices()), "card": card}


def peaks(device_kind: str) -> tuple[float, float]:
    if device_kind not in PEAKS:
        raise KeyError(f"no published peaks for {device_kind!r}; add the "
                       f"card to bench.PEAKS with its source")
    return PEAKS[device_kind]


def flagship_cfg(K=20):
    from desire.config import DesireConfig
    return DesireConfig(batch_size=64, max_num_obj=60, obs_len=8, pred_len=12,
                        num_samples=K, d_dim=48, latent_size=128,
                        compute_dtype="bfloat16", num_refine=4,
                        use_ioc=True, use_scf=True)


def make_batch(cfg, key=0):
    k = jax.random.PRNGKey(key)
    b, a, t = cfg.batch_size, cfg.max_num_obj, cfg.total_len
    xy = jax.random.uniform(k, (b, t, a, 2)) * 0.6 + 0.2
    mask = jnp.ones((b, t, a), jnp.float32)
    ids = jnp.arange(1, a + 1, dtype=jnp.float32)[None].repeat(b, 0)
    return xy, mask, ids


def cost(compiled) -> tuple[float, float]:
    """(flops, bytes accessed) of a compiled executable (XLA's analysis)."""
    ca = compiled.cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    return float(ca.get("flops", 0.0)), float(ca.get("bytes accessed", 0.0))


def time_calls(run, iters, warmup) -> float:
    """Seconds per call of run(), each call's result blocked on."""
    for _ in range(warmup):
        jax.block_until_ready(run())
    t0 = time.perf_counter()
    for _ in range(iters):
        out = run()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def _init(cfg):
    from desire.models.desire import init_desire
    return jax.jit(lambda k: init_desire(k, cfg))(jax.random.PRNGKey(0))


def bench(cfg=None, iters=10, warmup=3):
    """Inference path. Returns (traj_per_sec, sec, flops, bytes)."""
    from desire.models.desire import desire_forward
    cfg = cfg or flagship_cfg()
    params = _init(cfg)
    xy, mask, ids = make_batch(cfg)

    def fwd(params, xy, mask, ids, key):
        out = desire_forward(params, cfg, xy, mask, ids, key=key, train=False)
        return out["refined_traj"], out["scores"]

    keys = jax.random.split(jax.random.PRNGKey(1), warmup + iters)
    compiled = jax.jit(fwd).lower(params, xy, mask, ids, keys[0]).compile()
    it = iter(keys)
    dt = time_calls(lambda: compiled(params, xy, mask, ids, next(it)),
                    iters, warmup)
    traj_per_sec = cfg.batch_size * cfg.max_num_obj * cfg.num_samples / dt
    return (traj_per_sec, dt) + cost(compiled)


def bench_train(cfg=None, iters=10, warmup=3):
    """Full training step (fwd+bwd+Adam). Returns (steps/s, sec, flops,
    bytes)."""
    from desire.train import trainer
    from desire.train.state import create_train_state
    cfg = cfg or flagship_cfg(K=20)
    state = jax.jit(lambda k: create_train_state(
        cfg, _init(cfg), steps_per_epoch=190))(jax.random.PRNGKey(0))
    xy, mask, ids = make_batch(cfg)
    step_fn = trainer.make_train_step(cfg, 190)
    compiled = step_fn.lower(state, xy, mask, ids).compile()
    holder = {"state": state}      # the step donates its state

    def run():
        holder["state"], metrics = compiled(holder["state"], xy, mask, ids)
        return metrics["loss"]

    dt = time_calls(run, iters, warmup)
    return (1.0 / dt, dt) + cost(compiled)


def stages(iters=10, warmup=3):
    """Device time of each model stage at the flagship shapes, one JSON
    line each: the SGM sampler, scene pooling (forward, and forward with
    its backward), one social-pooling pass, the IOC rank/refine loop
    forward and forward+backward, the bivariate NLL forward+backward, and
    the end-to-end forward and train step."""
    from desire.models import ioc, losses, scf, sgm
    dev = device_record()
    cfg = flagship_cfg()
    params = _init(cfg)
    b, a, k, tf = (cfg.batch_size, cfg.max_num_obj, cfg.num_samples,
                   cfg.pred_len)
    n, d, c = b * a, cfg.d_dim, cfg.scene_channels
    ks = jax.random.split(jax.random.PRNGKey(1), 8)
    bf = jnp.bfloat16
    traj = jax.random.uniform(ks[0], (b, a, k, tf, 2), minval=0.2, maxval=0.8)
    dec_h = jax.random.normal(ks[1], (b, a, k, tf, d), bf)
    feat = jax.random.normal(ks[2], (b, cfg.scene_grid, cfg.scene_grid, c), bf)
    live = jnp.ones((b, a))
    fut_mask = jnp.ones((b, a, tf))
    obs = jax.random.uniform(ks[3], (n, cfg.obs_len, 2))
    obs_mask = jnp.ones((n, cfg.obs_len))
    raw5 = jax.random.normal(ks[4], (b, a, k, tf, 5))
    fut = jax.random.uniform(ks[5], (b, a, 1, tf, 2))
    msg = scf.social_messages(params["scf"], dec_h)

    def ioc_fwd(p, t):
        return ioc.ioc_forward(p["ioc"], p["scf"], cfg, t, dec_h, feat, live,
                               fut_mask)[:2]

    def pool(f, t):
        return scf.bilinear_pool(f, t.reshape(b, -1, 2))

    def ioc_loss(p, t):
        r, s = ioc_fwd(p, t)
        return jnp.sum(r) + jnp.sum(s.astype(jnp.float32))

    def timed(name, fn, args):
        compiled = jax.jit(fn).lower(*args).compile()
        row = {"stage": name,
               "ms": time_calls(lambda: compiled(*args), iters, warmup) * 1e3}
        print(json.dumps({**row, **dev}), flush=True)
        return row

    cases = {
        "sgm_sample": (lambda p, o, m, key: sgm.sgm_forward(
            p["sgm"], cfg, o, m, key=key, train=False)["dec_h"],
            (params, obs, obs_mask, ks[6])),
        "bilinear_pool": (pool, (feat, traj)),
        "bilinear_pool_forward_backward": (jax.grad(lambda f, t: jnp.sum(
            pool(f, t).astype(jnp.float32)), argnums=(0, 1)), (feat, traj)),
        "social_pool": (lambda p, t, m: scf.social_pool(p["scf"], t, m, live),
                        (params, traj, msg)),
        "ioc_forward": (ioc_fwd, (params, traj)),
        "ioc_forward_backward": (jax.grad(ioc_loss), (params, traj)),
        "nll_forward_backward": (jax.grad(lambda r: jnp.sum(
            losses.bivariate_nll(r, fut))), (raw5,)),
    }
    rows = [timed(name, *case) for name, case in cases.items()]
    for name, fn in (("forward", bench), ("train_step", bench_train)):
        row = {"stage": name, "ms": fn(cfg, iters, warmup)[1] * 1e3}
        print(json.dumps({**row, **dev}), flush=True)
        rows.append(row)
    return rows


def main():
    dev = device_record()
    peak_flops, peak_bps = peaks(dev["device_kind"])
    cfg = flagship_cfg()
    traj_per_sec, dt, flops, nbytes = bench(cfg)
    steps_per_sec, train_dt, t_flops, t_bytes = bench_train(cfg)
    print(json.dumps({
        "metric": "sampled_trajectories_per_sec_K20",
        "value": traj_per_sec,
        "unit": "traj/s",
        "fwd_ms": dt * 1e3,
        "train_steps_per_sec_K20": steps_per_sec,
        "train_step_ms": train_dt * 1e3,
        "mfu_fwd": flops / dt / peak_flops,
        "mfu_train": t_flops / train_dt / peak_flops,
        "hbm_frac_fwd": nbytes / dt / peak_bps,
        "hbm_frac_train": t_bytes / train_dt / peak_bps,
        **dev,
    }))


if __name__ == "__main__":
    from desire.utils.logging import enable_compile_cache
    enable_compile_cache()
    if "--stages" in sys.argv:
        stages()
    else:
        main()
