"""Real multi-PROCESS training test (SURVEY §2.4): two jax.distributed
processes (Gloo collectives over localhost, 2 virtual CPU devices each) train
on process-local loader shards; their losses must match each other AND a
single-process run on the same global batches.

This is the test tier the 8-virtual-device mesh cannot cover: per-process
data sharding (mesh.local_batch_rows + jax.make_array_from_process_local_data
in trainer.batch_to_device) and cross-process gradient all-reduce.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

from desire.config import DesireConfig

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def mp_cfg(data_dir: str) -> DesireConfig:
    """Shared by the parent (single-process reference run) and the workers."""
    return DesireConfig(
        batch_size=4, max_num_obj=4, obs_len=4, pred_len=4, subsample=1,
        window_hop=2, num_samples=2, d_dim=16, latent_size=8,
        embedding_size=8, channel_multiplier=10, scene_grid=8,
        scene_channels=4, num_refine=2, compute_dtype="float32",
        kld_warmup=0, data_dir=data_dir, save_dir="")


def _write_micro_csv(path, records):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    arr = np.asarray(records, dtype=np.float64).T
    with open(path, "w") as f:
        for row in arr:
            f.write(",".join(f"{v:g}" for v in row) + "\n")


@pytest.fixture
def mp_tree(tmp_path):
    recs = []
    rng = np.random.default_rng(3)
    for f in range(64):
        recs.append((f, 1, 10.0 + f + rng.normal(), 20.0 + 2 * f))
        recs.append((f, 2, 100.0 - f, 50.0 + rng.normal()))
        if f >= 8:
            recs.append((f, 3, 5.0 + 0.5 * f, 90.0 - f))
    _write_micro_csv(str(tmp_path / "sceneA/video0/annotations_processed.csv"),
                     recs)
    return str(tmp_path)


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_training_matches_single_process(mp_tree, tmp_path):
    port = _free_port()
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=_REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    outs = [str(tmp_path / f"out{p}.json") for p in (0, 1)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(_REPO, "tests", "_mp_worker.py"),
         str(p), str(port), mp_tree, outs[p]],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for p in (0, 1)]
    logs = [p.communicate(timeout=540)[0].decode() for p in procs]
    for p, lg in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{lg}"
    results = [json.load(open(o)) for o in outs]

    # both processes observed identical (replicated) losses and params
    np.testing.assert_allclose(results[0]["losses"], results[1]["losses"],
                               rtol=1e-6)
    np.testing.assert_allclose(results[0]["fingerprint"],
                               results[1]["fingerprint"], rtol=1e-6)

    # ...and they match a single-process, unsharded run on the same stream
    from desire.data.loader import SDDLoader
    from desire.models.desire import init_desire
    from desire.train import trainer
    from desire.train.state import create_train_state

    cfg = mp_cfg(mp_tree)
    loader = SDDLoader(cfg)
    params = init_desire(jax.random.PRNGKey(0), cfg)
    state = create_train_state(cfg, params, loader.num_batches)
    step_fn = trainer.make_train_step(cfg, loader.num_batches)
    ref_losses = []
    state, _ = trainer.run_epoch(
        state, loader, 0, step_fn, max_batches=3, log_every=1,
        log_fn=lambda m, s: ref_losses.append(m["loss"]))
    np.testing.assert_allclose(results[0]["losses"], ref_losses, rtol=1e-4)
