"""Checkpoint / resume on numpy and json alone (SURVEY §5 checkpoint row).

The reference half-implemented this: a tf.train.Saver wrote
save/social_model.ckpt every 400 steps (train.py:197-205) but **no restore
path existed anywhere** — training always restarted from scratch. Here:
full state (params, optimizer, step, PRNG key, data-pipeline position) with
keep-latest-N or keep-best-N retention, plus the config serialized alongside
(the reference pickled argparse args to save/config.pkl, train.py:102-103 —
we write JSON).

Layout: ``<directory>/<step>/state.npz`` holds every leaf of the state
pytree under its key path (``jax.tree_util.keystr``), and
``<directory>/<step>/meta.json`` the step, the loader position, the
retention metrics and each leaf's dtype. A step directory is written under
a temporary name and renamed into place, so a crash mid-save never leaves a
half-written checkpoint behind. Saves are synchronous; process 0 writes.
"""

from __future__ import annotations

import json
import os
import shutil

import jax
import numpy as np

from desire.config import DesireConfig
from desire.data.loader import LoaderState
from desire.train.state import TrainState

_STATE_FILE = "state.npz"
_META_FILE = "meta.json"


def _replicated_to_host(x):
    """Materialize a (possibly multi-host-replicated) array on this host."""
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        return np.asarray(x.addressable_shards[0].data)
    return x


def _key_data(key) -> np.ndarray:
    if jax.dtypes.issubdtype(key.dtype, jax.dtypes.prng_key):
        key = jax.random.key_data(key)
    return np.asarray(key)


def _state_tree(state: TrainState) -> dict:
    return {"params": state.params, "opt_state": state.opt_state,
            "step": state.step, "key": _key_data(state.key)}


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 keep_best_metric: str | None = None):
        """keep_best_metric: when set, retention keeps the `keep` BEST
        checkpoints by this (minimized) metric key instead of the latest
        `keep` — the candidate pool for the end-of-training full-split
        selection (train.py --final_select_top; VERDICT r4 item 8)."""
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep
        self.keep_best_metric = keep_best_metric

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def all_steps(self) -> list[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.exists(
                          os.path.join(self.directory, n, _META_FILE)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, loader_state: LoaderState,
             cfg: DesireConfig, wait: bool = False,
             metrics: dict | None = None) -> None:
        """Write `state` as the checkpoint of its step (replacing one of
        the same step) and apply retention. Saves complete before this
        returns, so `wait` has nothing left to wait for."""
        if jax.process_count() > 1:
            # multi-host: train state is replicated (trainer out_shardings),
            # so process 0 alone writes; other hosts' data is identical.
            # Replicated-but-not-fully-addressable arrays are materialized
            # from a local shard (every device holds the full array).
            if jax.process_index() != 0:
                return
            state = jax.tree_util.tree_map(_replicated_to_host, state)
        leaves, _ = jax.tree_util.tree_flatten_with_path(_state_tree(state))
        arrays, dtypes = {}, {}
        for path, leaf in leaves:
            name = jax.tree_util.keystr(path)
            arr = np.asarray(leaf)
            dtypes[name] = arr.dtype.name
            if arr.dtype.kind == "V":
                # extension float types (bfloat16, ...) are stored as raw
                # unsigned bits; meta.json records the real dtype
                arr = arr.view(f"u{arr.dtype.itemsize}")
            arrays[name] = arr
        step = int(np.asarray(state.step))
        meta = {"step": step, "loader_epoch": int(loader_state.epoch),
                "loader_batch": int(loader_state.batch_index),
                "metrics": metrics or {}, "dtypes": dtypes}
        final = self._step_dir(step)
        tmp = os.path.join(self.directory, f".tmp-{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with open(os.path.join(tmp, _STATE_FILE), "wb") as f:
            np.savez(f, **arrays)
        with open(os.path.join(tmp, _META_FILE), "w") as f:
            json.dump(meta, f, sort_keys=True)
        if os.path.exists(final):
            old = os.path.join(self.directory, f".old-{step}")
            shutil.rmtree(old, ignore_errors=True)
            os.replace(final, old)
            os.replace(tmp, final)
            shutil.rmtree(old)
        else:
            os.replace(tmp, final)
        cfg_path = os.path.join(self.directory, "config.json")
        with open(cfg_path + ".tmp", "w") as f:
            f.write(cfg.to_json())
        os.replace(cfg_path + ".tmp", cfg_path)
        self._retain()

    def _retain(self) -> None:
        steps = self.all_steps()
        if self.keep_best_metric is None:
            kept = steps[-self.keep:]
        else:
            def rank(s):
                m = self._meta(s)["metrics"].get(self.keep_best_metric)
                return (float("inf") if m is None else float(m), -s)
            kept = sorted(steps, key=rank)[:self.keep]
        for s in steps:
            if s not in kept:
                shutil.rmtree(self._step_dir(s))

    def _meta(self, step: int) -> dict:
        with open(os.path.join(self._step_dir(step), _META_FILE)) as f:
            return json.load(f)

    def restore(self, template_state: TrainState
                ) -> tuple[TrainState, LoaderState] | None:
        return self.restore_step(self.latest_step(), template_state)

    def restore_step(self, step: int | None, template_state: TrainState
                     ) -> tuple[TrainState, LoaderState] | None:
        """Restore checkpoint `step` into the structure of template_state.
        Every template leaf must be present with the template's shape."""
        if step is None:
            return None
        meta = self._meta(step)
        leaves, treedef = jax.tree_util.tree_flatten_with_path(
            _state_tree(template_state))
        out = []
        with np.load(os.path.join(self._step_dir(step), _STATE_FILE)) as z:
            if len(z.files) != len(leaves):
                raise ValueError(
                    f"checkpoint {step} in {self.directory} holds "
                    f"{len(z.files)} arrays, the template {len(leaves)}")
            for path, leaf in leaves:
                name = jax.tree_util.keystr(path)
                if name not in z.files:
                    raise ValueError(f"checkpoint {step} lacks {name}")
                arr = z[name]
                dtype = np.dtype(jax.numpy.dtype(meta["dtypes"][name]))
                if arr.dtype != dtype:
                    arr = arr.view(dtype)
                if arr.shape != np.shape(leaf):
                    raise ValueError(
                        f"checkpoint {step}: {name} has shape {arr.shape}, "
                        f"the template {np.shape(leaf)}")
                out.append(arr)
        got = jax.tree_util.tree_unflatten(treedef, out)
        key = got["key"]
        if jax.dtypes.issubdtype(template_state.key.dtype,
                                 jax.dtypes.prng_key):
            key = jax.random.wrap_key_data(key)
        state = TrainState(step=jax.numpy.asarray(got["step"]),
                           params=got["params"], opt_state=got["opt_state"],
                           key=jax.numpy.asarray(key))
        loader_state = LoaderState(epoch=meta["loader_epoch"],
                                   batch_index=meta["loader_batch"])
        return state, loader_state


def load_config(directory: str) -> DesireConfig | None:
    path = os.path.join(directory, "config.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return DesireConfig.from_json(f.read())


# Model-geometry fields: the config entries that shape the forward pass or
# the parameter pytree. Anything that restores a checkpoint (evaluate.py,
# serve.Predictor) must take these from the SAVED config, not the caller's
# defaults — e.g. input_norm changes the embed width (shape mismatch),
# vel_scale/speed_norm silently rescale every residual, social_freeze
# changes inference semantics.
GEOMETRY_FIELDS = (
    "d_dim", "latent_size", "embedding_size", "rnn_size", "num_layers",
    "channel_multiplier", "scene_grid", "scene_channels", "use_ioc",
    "use_scf", "use_social", "num_refine", "vel_scale", "speed_norm",
    "vel_gain", "vel_floor", "cond_prior", "learn_bound", "aniso_bound",
    "vae_dec", "input_norm", "pace_range", "pace_lanes", "social_freeze",
    "scene_image_channels", "scene_image_source", "z_temp_learn",
    "rank_blend_fit",
    "obs_len", "pred_len", "subsample", "max_num_obj", "protocol")


def overlay_geometry(cfg: DesireConfig, saved_cfg: DesireConfig,
                     skip: tuple | frozenset = ()) -> DesireConfig:
    """Overlay the saved checkpoint's geometry onto cfg (minus `skip` —
    fields the caller explicitly set, e.g. --num_refine 0 to eval the raw
    SGM hypotheses)."""
    return cfg.replace(**{f: getattr(saved_cfg, f) for f in GEOMETRY_FIELDS
                          if f not in skip})
