"""chip_smoke.py and bench.py off the card: both refuse to report without a
GPU, and chip_smoke's phases run end to end at a tiny size on the CPU (the
rehearsal of what the card runs at flagship size)."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import bench
import chip_smoke
from desire.config import DesireConfig
from desire.data.loader import SDDLoader

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = chip_smoke.SIZES["tiny"]


def _run_script(script, cwd, *args):
    return subprocess.run([sys.executable, script, *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "JAX_PLATFORMS": "cpu"})


def test_exits_nonzero_without_a_gpu():
    out = _run_script("chip_smoke.py", ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_exits_nonzero_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run_script("chip_smoke.py", str(tmp_path))
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_dataset_fills_the_agent_slots(tmp_path):
    size = {**TINY, "agents": 60, "live_agents": 55, "steps": 40}
    data = chip_smoke.write_dataset(str(tmp_path), size, seed=3)
    cfg = DesireConfig(data_dir=data, max_num_obj=60, batch_size=4,
                       holdout="none")
    batch = SDDLoader(cfg, use_native=False).materialize(4)
    live = (batch.ids > 0).sum(axis=1)
    assert live.min() >= 30, live          # most of the 60 slots carry agents
    obs = batch.xy[:, :cfg.obs_len][batch.mask[:, :cfg.obs_len] > 0]
    assert np.all((obs >= 0) & (obs <= 1))


def test_phases_run_at_tiny_size(capsys):
    dev = chip_smoke.run("tiny", seed=1, require_gpu=False)
    out = capsys.readouterr().out
    assert dev == {"platform": "cpu", "kind": "cpu",
                   "count": len(jax.devices())}
    for phase in ("train losses", "checkpoint step 2 restores",
                  "peak device memory", "serve:", "parity desire_forward"):
        assert phase in out, phase


def test_four_card_path_runs_on_the_cpu_mesh(capsys):
    dev = chip_smoke.run("tiny", seed=2, four_cards=True, require_gpu=False)
    out = capsys.readouterr().out
    assert dev["count"] == 8
    assert "four-cards train mesh (4, 1)" in out
    assert "four-cards k-sharded inference" in out


def test_bench_refuses_a_cpu_backend():
    with pytest.raises(RuntimeError, match="measures a GPU"):
        bench.device_record()
    out = _run_script("bench.py", ROOT)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_bench_has_no_peaks_for_an_unknown_card():
    assert bench.peaks("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    with pytest.raises(KeyError, match="no published peaks"):
        bench.peaks("Tesla V100-SXM2-16GB")


def test_bench_timing_blocks_on_every_result():
    calls = []

    def run():
        calls.append(1)
        return jax.numpy.ones(3) * len(calls)

    sec = bench.time_calls(run, iters=4, warmup=2)
    assert len(calls) == 6 and sec > 0


def test_chip_smoke_main_prints_the_device_record_last(monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "run", lambda **kw: {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1})
    assert chip_smoke.main([]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
