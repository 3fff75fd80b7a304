"""The jitted training step and epoch driver.

One XLA program per batch: loss -> grads -> clip -> adam -> new state, with
donated buffers. Under a mesh, batches shard over the 'data' axis and the
gradient all-reduce is emitted by the compiler from the sharding annotations
(SURVEY §2.4) — no hand-written collectives.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from desire.config import DesireConfig
from desire.models import desire
from desire.parallel import mesh as mesh_mod
from desire.train.state import TrainState, make_optimizer


def make_train_step(cfg: DesireConfig, steps_per_epoch: int,
                    mesh=None) -> Callable:
    tx = make_optimizer(cfg, steps_per_epoch)

    def step_fn(state: TrainState, xy, mask, ids, img=None):
        key, sub = jax.random.split(state.key)
        if cfg.speed_aug > 0:
            # global window zoom (config.py speed_aug): scale every agent in
            # a window by the same factor around the scene center — relative
            # inter-agent geometry is preserved (a uniform zoom), while the
            # decoder/NLL targets see a wider speed range per shape (the
            # along-track under-coverage behind the fast-agent error; with
            # input_norm the encoders are already scale-free so this trains
            # the speed-CONDITIONAL parts). Log-uniform in [e^-a, e^a];
            # clipped to stay in-scene (rare edge distortion, masked coords
            # are zeroed by the model anyway).
            sub, kz = jax.random.split(sub)
            s = jnp.exp(jax.random.uniform(
                kz, (xy.shape[0], 1, 1, 1), minval=-cfg.speed_aug,
                maxval=cfg.speed_aug))
            xy = jnp.clip(0.5 + (xy - 0.5) * s, 0.0, 1.0)

        def loss_fn(params):
            return desire.desire_loss(params, cfg, xy, mask, ids,
                                      key=sub, step=state.step,
                                      scene_image=img)

        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, state.params,
                                        updates)
        metrics["grad_norm"] = jnp.sqrt(sum(
            jnp.sum(jnp.square(g)) for g in jax.tree_util.tree_leaves(grads)))
        new_state = TrainState(step=state.step + 1, params=params,
                               opt_state=opt_state, key=key)
        return new_state, metrics

    if mesh is None:
        return jax.jit(step_fn, donate_argnums=(0,))
    bsh = mesh_mod.batch_sharding(mesh)
    rep = mesh_mod.replicated(mesh)
    in_sh = (rep, bsh, bsh, bsh)
    if cfg.scene_image_channels > 0:
        in_sh += (bsh,)   # the per-window scene raster shards with the batch
    return mesh_mod.under_mesh(mesh, jax.jit(
        step_fn,
        in_shardings=in_sh,
        out_shardings=(rep, rep),
        donate_argnums=(0,),
    ))


def make_eval_forward(cfg: DesireConfig, k_samples=None, mesh=None):
    """Jitted inference forward (z from the prior)."""
    def fwd(params, xy, mask, ids, key, img=None):
        return desire.desire_forward(params, cfg, xy, mask, ids, key=key,
                                     k_samples=k_samples, train=False,
                                     scene_image=img)
    if mesh is None:
        return jax.jit(fwd)
    bsh = mesh_mod.batch_sharding(mesh)
    rep = mesh_mod.replicated(mesh)
    in_sh = (rep, bsh, bsh, bsh, rep)
    if cfg.scene_image_channels > 0:
        in_sh += (bsh,)
    return mesh_mod.under_mesh(mesh, jax.jit(fwd, in_shardings=in_sh))


def batch_to_device(batch, sharding=None, global_batch: int | None = None):
    """Host batch -> (sharded) device arrays.

    Single-process: plain device_put with the sharding. Multi-process: the
    batch holds only THIS process's rows (loader sharded via
    mesh.local_batch_rows) and jax.make_array_from_process_local_data
    assembles the logically-global array across hosts — a whole-array
    device_put would require every host to hold (and agree on) every row.
    """
    arrs = [np.asarray(batch.xy, dtype=np.float32),
            np.asarray(batch.mask, dtype=np.float32),
            np.asarray(batch.ids, dtype=np.float32)]
    if getattr(batch, "image", None) is not None:
        # per-window scene raster rides along; callers splat the tuple into
        # the step (xy, mask, ids, *img)
        arrs.append(np.asarray(batch.image, dtype=np.float32))
    if sharding is None:
        return tuple(jnp.asarray(a) for a in arrs)
    if jax.process_count() == 1:
        return tuple(jax.device_put(jnp.asarray(a), sharding) for a in arrs)
    gb = global_batch if global_batch is not None else (
        arrs[0].shape[0] * jax.process_count())
    return tuple(
        jax.make_array_from_process_local_data(sharding, a,
                                               (gb,) + a.shape[1:])
        for a in arrs)


class NonFiniteLossError(RuntimeError):
    """Raised when training produces non-finite losses repeatedly (failure
    detection, SURVEY §5: fail fast and loud instead of silently writing
    NaN checkpoints; recovery = resume from the last good checkpoint)."""


def run_epoch(state: TrainState, loader, epoch: int, step_fn,
              log_fn=None, log_every: int = 20, start_batch: int = 0,
              mesh=None, max_batches: int | None = None,
              max_bad_steps: int = 3):
    """Drive one epoch; returns (state, mean_loss)."""
    sharding = mesh_mod.batch_sharding(mesh) if mesh is not None else None
    global_batch = loader.cfg.batch_size
    rows = None
    if sharding is not None and jax.process_count() > 1:
        # multi-host: this process materializes only its rows of each batch.
        # batch_to_device passes cfg.batch_size as the fixed global shape, so
        # a short remainder batch would mismatch at runtime (ADVICE r2)
        assert loader.drop_remainder, \
            "multi-process training requires drop_remainder batches"
        rows = mesh_mod.local_batch_rows(sharding, global_batch)
    losses_acc, t0 = [], time.time()
    bad = 0
    for bi, batch in enumerate(loader.epoch_batches(epoch, start_batch,
                                                    rows=rows),
                               start=start_batch):
        if max_batches is not None and bi - start_batch >= max_batches:
            break
        xy, mask, ids, *img = batch_to_device(batch, sharding, global_batch)
        state, metrics = step_fn(state, xy, mask, ids, *img)
        if bi % log_every == 0:
            # finiteness check rides the logging cadence — a per-step
            # float() would force a device sync and break async dispatch
            m = {k: float(v) for k, v in metrics.items()}
            if not (np.isfinite(m["loss"])
                    and np.isfinite(m.get("grad_norm", 0.0))):
                # do NOT hand a bad state to log_fn — train.py's log_fn
                # checkpoints on its save cadence, and a NaN-parameter
                # checkpoint can evict good ones (fail-fast intent, ADVICE
                # r1). The grad_norm check covers the POST-update params:
                # a finite loss (pre-update) with a non-finite gradient
                # still poisons the Adam step it just took (ADVICE r2)
                bad += 1
                if bad >= max_bad_steps:
                    raise NonFiniteLossError(
                        f"{bad} consecutive non-finite losses at epoch "
                        f"{epoch} batch {bi}; resume from the last good "
                        f"checkpoint")
                continue
            bad = 0
            if log_fn is not None:
                m.update(epoch=epoch, batch=bi, step=int(state.step),
                         sec_per_batch=(time.time() - t0) / max(bi - start_batch + 1, 1))
                log_fn(m, state)  # current state, for mid-epoch checkpointing
        losses_acc.append(metrics["loss"])
    mean_loss = float(np.mean([float(x) for x in losses_acc])) if losses_acc else float("nan")
    if losses_acc and not np.isfinite(mean_loss):
        # epoch-end failure detection: NaNs that land between the logged
        # cadence checks above still poison the mean — fail before the
        # caller checkpoints this state (train.py auto-recovers from the
        # last good checkpoint)
        raise NonFiniteLossError(
            f"epoch {epoch} mean loss is non-finite; resume from the last "
            f"good checkpoint")
    return state, mean_loss
