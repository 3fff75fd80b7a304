#!/usr/bin/env python
"""Smoke run of DESIRE on one NVIDIA GPU, through the normal entry points.

    python chip_smoke.py [--seed N]          # one card
    python chip_smoke.py --four-cards        # the (data, k) mesh on 4 cards

One process, one JAX client. Phases, each of which must pass:

  device   the default backend is a GPU (no CPU fallback); name the card
  train    train.main on a seeded SDD-format dataset at the flagship width
           (B=64, A=60, K=20, d=48, latent 128, bf16, 4+1 IOC passes) for
           a few steps; losses finite, parameters moved, the checkpoint
           restores
  serve    serve.Predictor loads that checkpoint and answers requests
  parity   desire_forward on the GPU against the same call on the CPU
           backend, float32 under "highest" precision, full widths, B=4
  memory   peak device memory after training

The main path has no hand-written kernel: XLA compiles all of it, and the
parity phase holds that whole compiled program to the CPU's.

``--four-cards`` runs only the mesh path and what it is compared with:
data-parallel training on a (4, 1) mesh at B=256 against one card, and
k-sharded inference on a (1, 4) mesh against one card. Training runs at
the flagship's bfloat16 (a float32 step at B=256 does not fit one card);
inference runs in float32 under "highest" precision, so that only the
order of reductions differs.

The last line of standard output is one JSON object
``{"ok": true, "device": {...}}``; it is printed only when every phase
passed. Without a GPU the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# Per-size settings. "flagship" is what runs on the card; "tiny" lets the
# CPU test suite drive every phase in seconds (tests/test_chip_smoke.py).
SIZES = {
    "flagship": dict(batch=64, agents=60, k=20, d=48, latent=128,
                     embedding=64, cm=100, grid=32, channels=32, refine=4,
                     obs=8, pred=12, train_batches=5, parity_batch=4,
                     requests=5, videos=4, steps=200, live_agents=55,
                     mesh_batch=256, mesh_steps=3, mesh_videos=9),
    "tiny": dict(batch=4, agents=6, k=3, d=16, latent=8, embedding=8, cm=10,
                 grid=8, channels=4, refine=2, obs=4, pred=4,
                 train_batches=2, parity_batch=2, requests=2, videos=1,
                 steps=40, live_agents=5, mesh_batch=8, mesh_steps=2,
                 mesh_videos=1),
}
SUBSAMPLE = 12      # the SDD protocol's 2.5 Hz (config.py subsample)
PARITY_ATOL = 1e-4  # GPU vs CPU refined_traj, normalized scene units


def say(*parts):
    print(*parts, flush=True)


def card_lines() -> list[str]:
    """`nvidia-smi --query-gpu=name,power.limit` lines, one per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def write_dataset(root: str, size: dict, seed: int) -> str:
    """SDD-format dataset (transposed 4-row frame/id/x/y CSVs, the layout
    of tests/test_data.py's fixtures): `videos` videos of one scene, each
    `steps` sampled steps long, with about `live_agents` agents on smooth
    paths in every frame. Frames are written on the subsample grid only.
    The four-card phase writes `mesh_videos` videos, so that its B=256
    batches come `mesh_steps` times."""
    rng = np.random.default_rng(seed)
    for vi in range(size["videos"]):
        recs, next_id = [], 1
        for _ in range(size["live_agents"]):
            start = 0
            while start < size["steps"]:
                life = int(rng.integers(30, 120))
                t = np.arange(start, min(start + life, size["steps"]))
                p0 = rng.uniform(100, 900, 2)
                v = rng.uniform(-6, 6, 2)
                turn = rng.uniform(-0.02, 0.02)
                ang = turn * (t - start)
                dx = v[0] * np.cos(ang) - v[1] * np.sin(ang)
                dy = v[0] * np.sin(ang) + v[1] * np.cos(ang)
                x = np.clip(p0[0] + np.cumsum(dx), 1, 999)
                y = np.clip(p0[1] + np.cumsum(dy), 1, 999)
                recs.append(np.stack([t * SUBSAMPLE,
                                      np.full(len(t), next_id), x, y]))
                next_id += 1
                start += life
        arr = np.concatenate(recs, axis=1)
        path = os.path.join(root, "smoke", f"video{vi}",
                            "annotations_processed.csv")
        os.makedirs(os.path.dirname(path))
        np.savetxt(path, arr, fmt="%.3f", delimiter=",")
    return root


def model_cfg(size: dict, **kw):
    from desire.config import DesireConfig
    base = dict(batch_size=size["batch"], max_num_obj=size["agents"],
                num_samples=size["k"], d_dim=size["d"],
                latent_size=size["latent"],
                embedding_size=size["embedding"],
                channel_multiplier=size["cm"], scene_grid=size["grid"],
                scene_channels=size["channels"], num_refine=size["refine"],
                obs_len=size["obs"], pred_len=size["pred"],
                subsample=SUBSAMPLE, compute_dtype="bfloat16",
                holdout="none")
    base.update(kw)
    return DesireConfig(**base)


def model_flags(size: dict) -> list[str]:
    """train.py flags for model_cfg(size): every field off its default."""
    from desire.config import DesireConfig
    cfg, default = model_cfg(size), DesireConfig()
    return [arg for f in dataclasses.fields(cfg)
            if getattr(cfg, f.name) != getattr(default, f.name)
            for arg in (f"--{f.name}", str(getattr(cfg, f.name)))]


def phase_train(size: dict, data_dir: str, save_dir: str, seed: int):
    import jax

    import train as train_mod
    from desire.models.desire import init_desire
    from desire.train import checkpoint as ckpt_mod
    from desire.train.state import create_train_state

    t0 = time.perf_counter()
    train_mod.main(["--data_dir", data_dir, "--save_dir", save_dir,
                    "--seed", str(seed), "--num_epochs", "1",
                    "--max_train_batches", str(size["train_batches"]),
                    "--eval_every", "0", "--final_select_top", "0",
                    *model_flags(size)])
    say(f"train: {size['train_batches']} steps in "
        f"{time.perf_counter() - t0:.1f} s (compile included)")
    events = [json.loads(ln) for ln in
              open(os.path.join(save_dir, "metrics.jsonl"))]
    losses = [e["loss"] for e in events if e["event"] == "train"]
    losses += [e["mean_loss"] for e in events if e["event"] == "epoch"]
    say(f"train losses (first step, epoch mean): {losses}")
    if not losses or not np.all(np.isfinite(losses)):
        raise AssertionError(f"training losses not finite: {losses}")

    cfg = ckpt_mod.load_config(save_dir)
    init = init_desire(jax.random.PRNGKey(cfg.seed), cfg)
    mgr = ckpt_mod.CheckpointManager(save_dir)
    got = mgr.restore(create_train_state(cfg, init, 10))
    if got is None:
        raise AssertionError(f"no checkpoint written in {save_dir}")
    state, _ = got
    if int(state.step) != size["train_batches"]:
        raise AssertionError(f"restored step {int(state.step)}")
    moved = max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
                for a, b in zip(jax.tree_util.tree_leaves(init),
                                jax.tree_util.tree_leaves(state.params)))
    say(f"checkpoint step {int(state.step)} restores; "
        f"max |param - init| {moved:.3g}")
    if not moved > 0:
        raise AssertionError("training did not change the parameters")
    return cfg


def phase_serve(size: dict, cfg, save_dir: str, power: str) -> None:
    from desire.data.loader import SDDLoader
    from desire.serve import Predictor

    pred = Predictor(save_dir, k_samples=size["k"],
                     max_windows=size["batch"]).warmup()
    batch = SDDLoader(cfg, drop_remainder=False).materialize(size["batch"])
    to = cfg.obs_len
    windows = [(np.swapaxes(batch.xy[i, :to], 0, 1),
                np.swapaxes(batch.mask[i, :to], 0, 1), batch.ids[i])
               for i in range(len(batch.ids))]
    live_slots = int((batch.ids > 0).sum())
    for _ in range(size["requests"]):
        outs = pred.predict_windows(windows)
    k, a, tf = size["k"], size["agents"], size["pred"]
    for o in outs:
        if o["traj"].shape != (a, k, tf, 2) or o["best"].shape != (a, tf, 2) \
                or o["scores"].shape != (a, k):
            raise AssertionError(f"forecast shapes {o['traj'].shape}")
        if not (np.isfinite(o["traj"][o["live"]]).all()
                and np.isfinite(o["scores"][o["live"]]).all()):
            raise AssertionError("non-finite forecast for a live agent")
    st = pred.stats()
    say(f"serve: {len(windows)} windows x {size['requests']} requests, "
        f"{live_slots} live agent slots per request; Predictor p50 "
        f"{st['latency_ms_p50']} ms, p95 {st['latency_ms_p95']} ms "
        f"(information only; card: {power})")


def phase_parity(size: dict, seed: int, gpu) -> None:
    import jax
    import jax.numpy as jnp

    from desire.models.desire import desire_forward, init_desire

    cfg32 = model_cfg(size, batch_size=size["parity_batch"],
                      compute_dtype="float32")
    b, a, t = cfg32.batch_size, cfg32.max_num_obj, cfg32.total_len
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    xy = jax.random.uniform(ks[0], (b, t, a, 2)) * 0.6 + 0.2
    mask = jnp.ones((b, t, a), jnp.float32)
    ids = jnp.arange(1, a + 1, dtype=jnp.float32)[None].repeat(b, 0)
    ids = ids.at[:, a - a // 6:].set(0.0)            # some empty slots
    params = init_desire(ks[1], cfg32)

    def fwd(cfg):
        return jax.jit(lambda p, xy, m, i, k: desire_forward(
            p, cfg, xy, m, i, key=k, train=False)["refined_traj"])

    cpu = jax.devices("cpu")[0]
    with jax.default_matmul_precision("highest"):
        args = (params, xy, mask, ids, ks[2])
        on_dev = np.asarray(fwd(cfg32)(*jax.device_put(args, gpu)))
        on_cpu = np.asarray(fwd(cfg32)(*jax.device_put(args, cpu)))
    err = float(np.max(np.abs(on_dev - on_cpu)))
    say(f"parity desire_forward f32 device vs CPU (B={b}, A={a}, "
        f"K={cfg32.num_samples}, d={cfg32.d_dim}): max|diff| {err:.3g} "
        f"(atol {PARITY_ATOL})")
    if not (np.isfinite(on_dev).all() and err <= PARITY_ATOL):
        raise AssertionError("GPU/CPU forward parity failed")
    bf = np.asarray(fwd(model_cfg(size, batch_size=b))(
        *jax.device_put(args, gpu)))
    say(f"bf16 vs f32 forward on the device: max|diff| "
        f"{float(np.max(np.abs(bf - on_dev))):.3g} (information only; the "
        f"latent noise is drawn in the compute dtype, so the draws differ)")


def phase_four_cards(size: dict, data_dir: str, seed: int) -> None:
    """(4, 1) data-parallel training (bfloat16) and (1, 4) k-sharded
    inference (float32, "highest") against one card."""
    import jax

    from desire.data.loader import SDDLoader
    from desire.models.desire import init_desire
    from desire.parallel import mesh as mesh_mod
    from desire.serve import Predictor
    from desire.train import trainer
    from desire.train.state import create_train_state

    devs = jax.devices()
    if len(devs) < 4:
        raise AssertionError(f"--four-cards needs 4 devices, has {len(devs)}")
    cfg = model_cfg(size, batch_size=size["mesh_batch"], data_dir=data_dir,
                    seed=seed)
    loader = SDDLoader(cfg)
    steps = min(size["mesh_steps"], loader.num_batches)
    batches = [trainer.batch_to_device(bt) for bt, _ in
               zip(loader.epoch_batches(0), range(steps))]
    runs = {}
    for name, mesh in (("one card", None),
                       ("mesh (4, 1)", mesh_mod.make_mesh(4, 1, devs))):
        state = create_train_state(
            cfg, init_desire(jax.random.PRNGKey(seed), cfg), 10)
        step = trainer.make_train_step(cfg, 10, mesh=mesh)
        sh = mesh_mod.batch_sharding(mesh) if mesh is not None else None
        ms = []
        for xy, mask, ids in batches:
            if sh is not None:
                xy, mask, ids = jax.device_put((xy, mask, ids), sh)
            state, m = step(state, xy, mask, ids)
            ms.append((float(m["loss"]), float(m["grad_norm"])))
        runs[name] = (ms, [np.asarray(x) for x in
                           jax.tree_util.tree_leaves(state.params)])
        say(f"four-cards train {name} B={cfg.batch_size} bf16: "
            f"(loss, grad_norm) per step {ms}")
    (m1, p1), (m4, p4) = runs["one card"], runs["mesh (4, 1)"]
    loss_rel = max(abs(a[0] - b[0]) / abs(a[0]) for a, b in zip(m1, m4))
    gn_rel = max(abs(a[1] - b[1]) / abs(a[1]) for a, b in zip(m1, m4))
    diff = np.concatenate([np.abs(a - b).ravel() for a, b in zip(p1, p4)])
    # bfloat16 activations: splitting the batch changes the order of
    # bf16-rounded partial sums, so losses agree to ~1e-3 and gradient
    # norms to ~1e-2. Adam normalizes each update, so a weight whose
    # gradient is near zero can step by a few lr either way on that noise:
    # the largest difference is bounded by 4 lr per step, and the mean
    # difference (over all weights) carries the tight check
    p_max = 4 * cfg.learning_rate * steps
    say(f"four-cards train: max rel loss diff {loss_rel:.3g} (rtol 2e-3), "
        f"max rel grad_norm diff {gn_rel:.3g} (rtol 3e-2), updated params "
        f"mean |diff| {diff.mean():.3g} (atol 1e-4), max {diff.max():.3g} "
        f"(atol {p_max:.3g})")
    if not (loss_rel <= 2e-3 and gn_rel <= 3e-2 and diff.mean() <= 1e-4
            and diff.max() <= p_max):
        raise AssertionError("data-parallel training diverged from one card")

    icfg = model_cfg(size, compute_dtype="float32")
    params = init_desire(jax.random.PRNGKey(seed + 1), icfg)
    bt = SDDLoader(icfg.replace(data_dir=data_dir)).materialize(
        size["batch"])
    to = icfg.obs_len
    windows = [(np.swapaxes(bt.xy[i, :to], 0, 1),
                np.swapaxes(bt.mask[i, :to], 0, 1), bt.ids[i])
               for i in range(len(bt.ids))]
    key = jax.random.PRNGKey(seed + 2)
    outs = {}
    with jax.default_matmul_precision("highest"):
        for name, mesh in (("one card", None),
                           ("mesh (1, 4)", mesh_mod.make_mesh(1, 4, devs))):
            pred = Predictor(params=params, cfg=icfg, mesh=mesh,
                             max_windows=size["batch"])
            outs[name] = np.stack([o["traj"] for o in
                                   pred.predict_windows(windows, key=key)])
    err = float(np.max(np.abs(outs["one card"] - outs["mesh (1, 4)"])))
    say(f"four-cards k-sharded inference K={icfg.num_samples}: "
        f"max |traj diff| vs one card {err:.3g} (atol 1e-4)")
    if not (np.isfinite(outs["mesh (1, 4)"]).all() and err <= 1e-4):
        raise AssertionError("k-sharded inference diverged from one card")


def run(size_name: str = "flagship", *, seed: int = 0,
        four_cards: bool = False, require_gpu: bool = True) -> dict:
    """Run the phases; raise on the first failure. Returns the device
    record of the last line. require_gpu=False (tests only) runs on
    whatever backend is there."""
    import jax

    size = SIZES[size_name]
    backend = jax.default_backend()
    if require_gpu and backend != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX backend {backend!r})")
    dev = jax.devices()[0]
    say(f"devices: {jax.devices()}")
    say(f"device_kind: {dev.device_kind}")
    power = "; ".join(card_lines()) if require_gpu else "not available"
    say(f"card (nvidia-smi name, power.limit): {power}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        data_dir = write_dataset(
            os.path.join(tmp, "data"),
            {**size, "videos": size["mesh_videos"]} if four_cards else size,
            seed)
        if four_cards:
            phase_four_cards(size, data_dir, seed)
        else:
            cfg = phase_train(size, data_dir, os.path.join(tmp, "ckpt"),
                              seed)
            stats = dev.memory_stats() or {}
            peak = stats.get("peak_bytes_in_use")
            say("peak device memory after training: "
                + (f"{peak / 2**30:.2f} GiB ({peak} bytes)"
                   if peak is not None else "not available"))
            phase_serve(size, cfg, os.path.join(tmp, "ckpt"), power)
            phase_parity(size, seed, dev)
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card mesh path and its comparison")
    args = ap.parse_args(argv)
    device = run(seed=args.seed, four_cards=args.four_cards)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
