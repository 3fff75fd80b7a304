"""Reference-shaped API facade.

Lets a user of the reference repo (tdavchev/DESIRE) switch with minimal code
changes: the class name, constructor contract (an argparse-style ``args``
namespace with the reference's flag names, train.py:30-88) and the
``sample()`` signature/tensor layout (model/model.py:613-688 — numpy arrays
of shape (T, max_num_obj, 3) with column 0 = agent id) are preserved, while
execution is the vectorized JAX pipeline underneath.

Differences from the reference (all deliberate — SURVEY §8 catalogues the
reference's defects):
* the constructor actually produces a *trainable* model (the reference's
  train op was never wired);
* ``sample`` runs one jitted program for all agents and all K hypotheses
  instead of a per-step session loop, and needs no tf.Session argument
  (pass None);
* ``train_step(x_batch, y_batch)`` replaces the manual
  ``sess.run(model.cost, feed)`` loop and actually optimizes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from desire.config import DesireConfig
from desire.eval.sampler import make_rollout, make_sampler
from desire.models.desire import init_desire
from desire.train import trainer
from desire.train.state import create_train_state


def _cfg_from_args(args) -> DesireConfig:
    known = {f.name for f in DesireConfig.__dataclass_fields__.values()}
    kw = {k: v for k, v in vars(args).items() if k in known}
    cfg = DesireConfig(**kw)
    # reference semantics: seq_length windows at native rate, no obs/pred
    # split -> compat protocol with obs = seq_length
    if "protocol" not in kw:
        cfg = cfg.replace(protocol="compat", obs_len=cfg.seq_length,
                          pred_len=cfg.seq_length, normalize=False)
    return cfg


class DESIREModel:
    """Drop-in-shaped counterpart of reference ``model.DESIREModel``."""

    def __init__(self, args, seed: int = 0):
        self.args = args
        self.cfg = _cfg_from_args(args)
        self.params = init_desire(jax.random.PRNGKey(seed), self.cfg)
        self._state = create_train_state(self.cfg, self.params,
                                         steps_per_epoch=100)
        self._step_fn = trainer.make_train_step(self.cfg, 100)
        self._key = jax.random.PRNGKey(seed + 1)
        self._samplers = {}  # (obs_len,) -> jitted rollout (avoid recompiles)
        # Coordinate scale: the reference fed raw SDD pixels, but the model's
        # physical priors (vel_scale displacement bounds, IOC delta scale,
        # SCF scene-grid mapping) are calibrated to [0,1] scene units — raw
        # thousand-pixel coords would pin the decoder to its tanh bounds and
        # collapse all agents onto one scene-grid corner (ADVICE r1). The
        # scale locks to a power of two covering the first batch seen and
        # every output is denormalized back to input units.
        self._scale = None

    def _lock_scale(self, coords: np.ndarray) -> float:
        if self._scale is None:
            hi = float(np.max(coords)) if coords.size else 1.0
            self._scale = float(2.0 ** np.ceil(np.log2(max(hi, 1.0))))
        return self._scale

    # -- training -----------------------------------------------------------
    def train_step(self, x_batch: np.ndarray, y_batch: np.ndarray) -> float:
        """One optimizer step on a reference-layout sequence pair.

        x_batch/y_batch: (seq_length, max_num_obj, 3) with col 0 = id
        (exactly what reference train.py:158-179 fed). y is the one-frame-
        shifted source. Returns the batch loss.
        """
        x = np.asarray(x_batch, np.float32)
        y = np.asarray(y_batch, np.float32)
        # reconstruct the (1, T+1, A, 2) window: x frames then y's last frame
        seq = np.concatenate([x[None], y[None, -1:]], axis=1)
        present = seq[..., 0] > 0
        scale = self._lock_scale(seq[..., 1:3][present])
        xy = jnp.asarray(seq[..., 1:3] / scale)
        # slot id = the id wherever the slot is occupied (the reference keyed
        # ids per-frame; frame 0 alone drops late-appearing agents)
        ids = jnp.asarray(seq[0, :, :, 0].max(axis=0)[None])
        mask = jnp.asarray(present.astype(np.float32))
        self._state, metrics = self._step_fn(self._state, xy, mask, ids)
        self.params = self._state.params
        return float(metrics["loss"])

    @property
    def cost(self) -> float:
        """Last-step loss is returned from train_step; kept for surface
        familiarity."""
        raise AttributeError(
            "cost is returned by train_step(); the TF placeholder/session "
            "pattern has no equivalent here")

    # -- inference ------------------------------------------------------------
    def sample(self, sess, traj, grid=None, dimensions=None, true_traj=None,
               num: int = 10):
        """Reference-signature sampling (model/model.py:613).

        traj: (obs_length, max_num_obj, 3) numpy, col 0 = id. `sess`, `grid`,
        `dimensions`, `true_traj` are accepted for signature parity; sess and
        grid are unused (no session; no social grid — SCF replaces it).
        Returns (obs_length + num, max_num_obj, 3).
        """
        del sess, grid, true_traj
        traj = np.asarray(traj, np.float32)
        to, a, _ = traj.shape
        present_in = traj[:, :, 0] > 0
        if dimensions is not None:
            # reference passed the scene (width, height) here — the natural
            # normalization scale when provided
            self._scale = self._scale or float(max(*dimensions, 1.0))
        scale = self._lock_scale(traj[..., 1:3][present_in])
        traj = traj.copy()
        traj[..., 1:3] /= scale
        # the temporal-conv filter spans a fixed observation window (exactly
        # like the reference's (1, seq_len, 2, 100) filter), so arbitrary
        # obs lengths are left-padded (mask 0) or trimmed to the trained
        # window — one compiled geometry, no per-length recompiles
        t_obs = self.cfg.seq_length
        # paper protocol so split_batch splits at the obs window (under
        # protocol='compat' the split is pinned differently)
        cfg = self.cfg.replace(protocol="paper", obs_len=t_obs,
                               pred_len=self.cfg.seq_length, subsample=1)
        if t_obs not in self._samplers:
            self._samplers[t_obs] = make_rollout(
                cfg, k_samples=self.cfg.num_samples)
        sampler = self._samplers[t_obs]

        win = traj[-t_obs:]
        pad = t_obs - win.shape[0]
        if pad > 0:
            win = np.concatenate([np.zeros((pad, a, 3), np.float32), win], 0)
        obs_xy = jnp.asarray(win[None, :, :, 1:3]).swapaxes(1, 2)  # (1,A,T,2)
        obs_mask = jnp.asarray((win[None, :, :, 0] > 0)
                               .astype(np.float32)).swapaxes(1, 2)
        # slot id = id at ANY frame the slot is occupied, not frame 0 (an
        # agent appearing mid-window would otherwise be masked out)
        slot_ids = traj[:, :, 0].max(axis=0)               # (A,)
        ids = jnp.asarray(slot_ids[None])
        self._key, sub = jax.random.split(self._key)
        chunks = -(-num // cfg.pred_len)
        full = sampler(self.params, obs_xy, obs_mask, ids, sub,
                       num_chunks=chunks)                  # (1, A, T+*, 2)
        pred = np.asarray(full[0].swapaxes(0, 1), np.float32)[t_obs:
                                                              t_obs + num]
        out = np.zeros((to + num, a, 3), np.float32)
        out[to:, :, 1:3] = pred * scale
        out[to:, :, 0] = slot_ids[None]                    # carry ids forward
        out[:to] = traj
        out[:to, :, 1:3] *= scale                          # back to input units
        return out
