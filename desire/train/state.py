"""Train state + optimizer (reference C17/C19 semantics, fixed).

The reference intended Adam + global-norm clipping 10 + per-epoch exponential
LR decay 0.95 (train.py:49-59,122-126; model/model.py:388-394) but never wired
a working train op (SURVEY §8). Here: optax chain, staircase exponential decay
keyed on the step counter, one jitted update per *batch* (vs the reference's
per-sequence session.run, train.py:146-181 — hot loop #3)."""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import optax

from desire.config import DesireConfig


class TrainState(NamedTuple):
    step: jnp.ndarray        # ()
    params: Any
    opt_state: Any
    key: jax.Array           # PRNG carried across steps


def make_schedule(cfg: DesireConfig, steps_per_epoch: int):
    """lr * decay_rate**epoch, staircase — exactly the reference's per-epoch
    assign (train.py:122-126)."""
    return optax.exponential_decay(
        init_value=cfg.learning_rate,
        transition_steps=max(steps_per_epoch, 1),
        decay_rate=cfg.decay_rate,
        staircase=True)


def make_optimizer(cfg: DesireConfig, steps_per_epoch: int):
    return optax.chain(
        optax.clip_by_global_norm(cfg.grad_clip),
        optax.adam(make_schedule(cfg, steps_per_epoch)),
    )


def create_train_state(cfg: DesireConfig, params, steps_per_epoch: int,
                       key=None) -> TrainState:
    tx = make_optimizer(cfg, steps_per_epoch)
    return TrainState(
        step=jnp.zeros((), jnp.int32),
        params=params,
        opt_state=tx.init(params),
        key=key if key is not None else jax.random.PRNGKey(cfg.seed),
    )
