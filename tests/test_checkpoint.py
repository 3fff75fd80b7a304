"""The numpy/json checkpoint format (train/checkpoint.py), old configs, the
compile-cache placement rule, and which packages the entry points import."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from desire.config import DesireConfig
from desire.data.loader import LoaderState
from desire.models.desire import init_desire
from desire.train import checkpoint as ckpt_mod
from desire.train.state import create_train_state
from desire.utils import logging as log_mod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(**kw):
    base = dict(max_num_obj=3, obs_len=2, pred_len=2, num_samples=2,
                d_dim=4, latent_size=2, embedding_size=4,
                channel_multiplier=2, scene_grid=4, scene_channels=2,
                num_refine=1)
    base.update(kw)
    return DesireConfig(**base)


def _state(cfg, seed=0, step=0):
    st = create_train_state(cfg, init_desire(jax.random.PRNGKey(seed), cfg),
                            10)
    return st._replace(step=jnp.asarray(step, jnp.int32))


def test_layout_is_npz_and_json_per_step_with_nothing_left_over(tmp_path):
    cfg = _cfg()
    mgr = ckpt_mod.CheckpointManager(str(tmp_path))
    mgr.save(_state(cfg, step=7), LoaderState(epoch=2, batch_index=5), cfg)
    assert sorted(os.listdir(tmp_path)) == ["7", "config.json"]
    assert sorted(os.listdir(tmp_path / "7")) == ["meta.json", "state.npz"]
    meta = json.loads((tmp_path / "7" / "meta.json").read_text())
    assert (meta["step"], meta["loader_epoch"], meta["loader_batch"]) == \
        (7, 2, 5)
    with np.load(tmp_path / "7" / "state.npz") as z:
        assert "['params']['sgm']['embed_x']['w']" in z.files
        assert "['step']" in z.files and "['key']" in z.files
    assert DesireConfig.from_json((tmp_path / "config.json").read_text()) \
        == cfg


def test_keep_latest_n_retention_and_resave_of_a_step(tmp_path):
    cfg = _cfg()
    mgr = ckpt_mod.CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(_state(cfg, step=s), LoaderState(), cfg)
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    # saving an existing step replaces it
    mgr.save(_state(cfg, seed=5, step=4), LoaderState(), cfg)
    got, _ = mgr.restore(_state(cfg))
    want = jax.tree_util.tree_leaves(_state(cfg, seed=5).params)
    for a, b in zip(jax.tree_util.tree_leaves(got.params), want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_keep_best_n_by_metric(tmp_path):
    cfg = _cfg()
    mgr = ckpt_mod.CheckpointManager(str(tmp_path), keep=2,
                                     keep_best_metric="minADE_px")
    for s, m in ((1, 5.0), (2, 3.0), (3, 9.0), (4, 4.0)):
        mgr.save(_state(cfg, step=s), LoaderState(), cfg,
                 metrics={"minADE_px": m})
    assert mgr.all_steps() == [2, 4]


def test_restore_refuses_a_template_of_another_shape(tmp_path):
    mgr = ckpt_mod.CheckpointManager(str(tmp_path))
    mgr.save(_state(_cfg(), step=1), LoaderState(), _cfg())
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(_state(_cfg(d_dim=6)))
    assert ckpt_mod.CheckpointManager(str(tmp_path / "empty")).restore(
        _state(_cfg())) is None


def test_bfloat16_leaves_round_trip(tmp_path):
    cfg = _cfg()
    st = _state(cfg, step=3)
    st = st._replace(params=jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16), st.params))
    mgr = ckpt_mod.CheckpointManager(str(tmp_path))
    mgr.save(st, LoaderState(), cfg)
    got, _ = mgr.restore(st)
    for a, b in zip(jax.tree_util.tree_leaves(got.params),
                    jax.tree_util.tree_leaves(st.params)):
        assert a.dtype == jnp.bfloat16
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_old_config_with_retired_kernel_flags_restores():
    """config.json files written before the GPU port carry use_pallas and
    fused_train; from_json ignores keys it does not know."""
    d = json.loads(_cfg().to_json())
    d.update(use_pallas=True, fused_train=True)
    cfg = DesireConfig.from_json(json.dumps(d))
    assert cfg == _cfg()
    assert not hasattr(cfg, "use_pallas") and not hasattr(cfg, "fused_train")


def test_compile_cache_defaults_to_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert log_mod.compile_cache_dir() == os.path.join(ROOT, ".jax_cache")
    # the data cache's variable does not move the compile cache
    monkeypatch.setenv("DESIRE_CACHE_DIR", "/elsewhere")
    assert log_mod.compile_cache_dir() == os.path.join(ROOT, ".jax_cache")


def test_compile_cache_honours_jax_compilation_cache_dir(monkeypatch,
                                                        tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert log_mod.compile_cache_dir() == str(tmp_path)
    before = jax.config.jax_compilation_cache_dir
    log_mod.enable_compile_cache(min_compile_secs=2.0)
    # JAX reads the variable itself: no directory is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_entry_points_do_not_import_orbax():
    code = ("import sys; import train, evaluate, predict, desire.serve; "
            "print(sorted(m for m in sys.modules if m.startswith('orbax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
