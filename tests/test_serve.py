"""Serving-surface tests: Predictor (observation-only forecasting on fixed
shapes), StreamServer (rolling frame feed), and the predict.py CLI.

Unlike evaluate.py's harness, nothing here consumes ground-truth futures —
the contract under test is the module docstring of desire/serve.py:
the unknown future is refined/scored across the full horizon for every
agent live at the last observed step."""

import json
import os

import jax
import numpy as np
import pytest

from desire.config import DesireConfig
from desire.models.desire import init_desire
from desire.serve import Predictor, StreamServer, forecast_to_json
from desire.train import checkpoint as ckpt_mod
from desire.train.state import create_train_state


def _cfg(**kw):
    base = dict(batch_size=4, max_num_obj=8, obs_len=4, pred_len=4,
                subsample=2, window_hop=2, num_samples=3, d_dim=16,
                latent_size=8, embedding_size=8, channel_multiplier=10,
                scene_grid=8, scene_channels=4, num_refine=2,
                compute_dtype="float32", save_dir="", seed=0)
    base.update(kw)
    return DesireConfig(**base)


@pytest.fixture(scope="module")
def pred():
    cfg = _cfg()
    params = init_desire(jax.random.PRNGKey(0), cfg)
    return Predictor(params=params, cfg=cfg, max_windows=2, seed=1)


def _window(cfg, na=3, speed=2.0, scale=100.0, seed=0):
    """na straight-line agents, raw pixels; present at every obs step."""
    rng = np.random.RandomState(seed)
    to = cfg.obs_len
    t = np.arange(to, dtype=np.float32)
    p0 = rng.uniform(20, 60, (na, 2)).astype(np.float32)
    v = rng.uniform(-speed, speed, (na, 2)).astype(np.float32)
    oxy = p0[:, None] + v[:, None] * t[None, :, None]   # (A, To, 2)
    om = np.ones((na, to), np.float32)
    ids = np.arange(1, na + 1, dtype=np.int64)
    return oxy * (scale / 100.0), om, ids


def test_predict_shapes_and_units(pred):
    cfg = pred.cfg
    oxy, om, ids = _window(cfg)
    out = pred.predict(oxy, om, ids, scale=100.0,
                       key=jax.random.PRNGKey(7))
    k, tf = cfg.num_samples, cfg.pred_len
    assert out["traj"].shape == (3, k, tf, 2)
    assert out["scores"].shape == (3, k)
    assert out["best"].shape == (3, tf, 2)
    assert out["live"].all()
    assert np.isfinite(out["traj"]).all() and np.isfinite(out["scores"]).all()
    # outputs are in input units: predictions land near the scene, not near
    # the normalized [0,1] square
    assert np.abs(out["best"]).max() > 2.0
    # best is the argmax-score lane (serving contract = eval harness's
    # best_of_k_by_score)
    pick = out["traj"][np.arange(3), np.argmax(out["scores"], -1)]
    np.testing.assert_allclose(out["best"], pick, rtol=1e-6)


def test_scale_equivariance(pred):
    """Forecasting pixels at scale s == forecasting normalized then * s."""
    oxy, om, ids = _window(pred.cfg)
    key = jax.random.PRNGKey(3)
    a = pred.predict(oxy, om, ids, scale=100.0, key=key)
    b = pred.predict(oxy / 100.0, om, ids, scale=1.0, key=key)
    np.testing.assert_allclose(a["traj"], b["traj"] * 100.0, rtol=2e-5,
                               atol=1e-3)


def test_agent_dead_at_last_step_is_dropped(pred):
    oxy, om, ids = _window(pred.cfg)
    om[1, -1] = 0.0                      # agent 2 vanished at the last step
    out = pred.predict(oxy, om, ids, scale=100.0)
    assert list(out["live"]) == [True, False, True]
    assert out["ids"][1] == 0


def test_predict_windows_batches_beyond_capacity(pred):
    cfg = pred.cfg
    wins = [_window(cfg, seed=s) for s in range(5)]    # > max_windows=2
    outs = pred.predict_windows([w for w in wins], scales=100.0)
    assert len(outs) == 5
    for (oxy, om, ids), out in zip(wins, outs):
        assert out["traj"].shape[0] == len(ids)
        assert np.isfinite(out["traj"]).all()


def test_stream_server_emits_on_schedule(pred):
    cfg = pred.cfg
    sub = cfg.subsample
    srv = StreamServer(pred, scale=100.0)
    v = np.array([1.5, -0.8], np.float32)
    outs = []
    for f in range(0, cfg.obs_len * sub + sub, 1):     # includes off-grid
        agents = [(5, 40 + v[0] * f, 50 + v[1] * f),
                  (9, 60 - v[0] * f, 30 + v[1] * f)]
        out = srv.observe(f, agents)
        if (f % sub) or (f // sub) + 1 < cfg.obs_len:
            assert out is None           # off-grid or not enough history
        else:
            assert out is not None
            outs.append(out)
    assert len(outs) == 2                # steps obs_len-1 and obs_len
    assert sorted(outs[0]["ids"].tolist()) == [5, 9]
    assert outs[0]["step"] == cfg.obs_len - 1
    assert outs[1]["frame"] == cfg.obs_len * sub
    line = forecast_to_json(outs[-1], top_k=2)
    rec = json.loads(line)
    assert len(rec["agents"]) == 2
    assert len(rec["agents"][0]["hypotheses"]) == 2
    assert len(rec["agents"][0]["top1"]) == cfg.pred_len


def test_stream_server_evicts_stale_agents(pred):
    cfg = pred.cfg
    sub = cfg.subsample
    srv = StreamServer(pred, scale=100.0)
    for f in range(0, 2 * sub, sub):                  # agent 7 seen twice
        srv.observe(f, [(7, 10 + f, 10), (8, 90, 90 - f)])
    for f in range(2 * sub, (2 + cfg.obs_len) * sub, sub):  # then gone
        out = srv.observe(f, [(8, 90, 90 - f)])
    assert 7 not in srv.hist
    assert out is not None and out["ids"].tolist() == [8]


def test_mesh_sharded_serving_matches_single_device():
    """Scale-out serving: a (data=4, k=2) mesh Predictor returns the same
    forecasts as the unsharded one (same params, same key)."""
    from desire.parallel import mesh as mesh_mod
    cfg = _cfg(num_samples=4, mesh_data=4, mesh_k=2)
    params = init_desire(jax.random.PRNGKey(0), cfg)
    mesh = mesh_mod.make_mesh(4, 2)
    p1 = Predictor(params=params, cfg=cfg.replace(mesh_data=1, mesh_k=1),
                   max_windows=4)
    p8 = Predictor(params=params, cfg=cfg, max_windows=4, mesh=mesh)
    wins = [_window(cfg, seed=s) for s in range(4)]
    key = jax.random.PRNGKey(11)
    a = p1.predict_windows(wins, scales=100.0, key=key)
    b = p8.predict_windows(wins, scales=100.0, key=key)
    for oa, ob in zip(a, b):
        np.testing.assert_allclose(oa["traj"], ob["traj"], rtol=2e-5,
                                   atol=1e-3)
        np.testing.assert_allclose(oa["scores"], ob["scores"], rtol=2e-4,
                                   atol=1e-4)
    with pytest.raises(ValueError):
        Predictor(params=params, cfg=cfg, max_windows=3, mesh=mesh)


def _save_checkpoint(tmp_path, cfg):
    params = init_desire(jax.random.PRNGKey(0), cfg)
    state = create_train_state(cfg, params, steps_per_epoch=10)
    from desire.data.loader import LoaderState
    mgr = ckpt_mod.CheckpointManager(str(tmp_path))
    mgr.save(state, LoaderState(), cfg, wait=True)
    return params


def test_predictor_restores_geometry_from_checkpoint(tmp_path):
    cfg = _cfg(d_dim=24, num_refine=1)   # geometry differing from defaults
    params = _save_checkpoint(tmp_path, cfg)
    p = Predictor(str(tmp_path), max_windows=1)
    assert p.cfg.d_dim == 24 and p.cfg.num_refine == 1
    assert p.obs_len == cfg.obs_len and p.pred_len == cfg.pred_len
    leaves = zip(jax.tree_util.tree_leaves(params),
                 jax.tree_util.tree_leaves(p.params))
    assert all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in leaves)
    out = p.predict(*_window(cfg), scale=100.0)
    assert np.isfinite(out["traj"]).all()
    stats = p.stats()
    assert stats["calls"] == 1 and stats["latency_ms_p50"] > 0


def test_predict_cli_stream_mode(tmp_path, capsys, monkeypatch):
    import io

    cfg = _cfg()
    _save_checkpoint(tmp_path / "ckpt", cfg)
    sub, to = cfg.subsample, cfg.obs_len
    lines = []
    for f in range(0, (to + 1) * sub):
        lines.append(json.dumps(
            {"frame": f,
             "agents": [[2, 30 + 1.1 * f, 40 - 0.4 * f],
                        [6, 70 - 0.8 * f, 25 + 0.9 * f]]}))
    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(lines) + "\n"))
    import predict
    predict.main(["--save_dir", str(tmp_path / "ckpt"), "--stream",
                  "--scale", "120", "--top_k", "1"])
    out = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert out[0]["ready"] and out[0]["subsample"] == sub
    forecasts = [r for r in out if "agents" in r]
    assert len(forecasts) == 2           # steps to-1 and to
    assert {a["id"] for a in forecasts[0]["agents"]} == {2, 6}
    assert len(forecasts[0]["agents"][0]["top1"]) == cfg.pred_len


def test_predict_cli_file_mode(tmp_path, capsys):
    # synthetic video CSV in the reference's transposed 4-row layout
    cfg = _cfg()
    _save_checkpoint(tmp_path / "ckpt", cfg)
    rng = np.random.RandomState(1)
    recs = []
    for aid in range(1, 5):
        v, p0 = rng.uniform(-1.5, 1.5, 2), rng.uniform(20, 80, 2)
        for f in range(40):
            p = p0 + v * f
            recs.append((f, aid, p[0], p[1]))
    arr = np.asarray(recs, np.float64).T
    csv = tmp_path / "scene" / "video0" / "annotations_processed.csv"
    os.makedirs(csv.parent, exist_ok=True)
    with open(csv, "w") as f:
        for row in arr:
            f.write(",".join(f"{x:g}" for x in row) + "\n")

    import predict
    predict.main(["--save_dir", str(tmp_path / "ckpt"), "--csv", str(csv),
                  "--top_k", "2"])
    out = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(out[-1])
    assert rec["video"] == str(csv)
    assert rec["agents"] and len(rec["agents"][0]["hypotheses"]) == 2
    # forecast coordinates are raw pixels on this video's extent
    flat = np.asarray(rec["agents"][0]["top1"], np.float64)
    assert np.abs(flat).max() > 2.0
