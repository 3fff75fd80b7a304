#!/usr/bin/env python
"""Training entry point — flag-compatible with the reference
(/root/reference/train.py:24-91) plus the promoted/new flags
(desire.config). Unlike the reference (whose train op was never wired,
SURVEY §8), this trains: jitted batch-level Adam steps, checkpoints with
resume, JSONL metrics, periodic eval.

Examples:
  python train.py --data_dir /root/reference/data --scenes bookstore \
      --num_epochs 5 --batch_size 32
  python train.py --resume 1 --save_dir save/   # continue from latest ckpt
"""

import argparse
import os
import sys

import jax
import jax.profiler  # noqa: F401  (train --profile_dir)

from desire.config import DesireConfig, add_config_flags, config_from_args
from desire.data.loader import LoaderState, SDDLoader
from desire.eval.sampler import evaluate
from desire.models.desire import init_desire
from desire.parallel import mesh as mesh_mod
from desire.train import checkpoint as ckpt_mod
from desire.train import trainer
from desire.train.state import create_train_state
from desire.utils.logging import MetricLogger


def main(argv=None):
    from desire.utils.logging import enable_compile_cache
    enable_compile_cache()
    parser = argparse.ArgumentParser(description=__doc__)
    add_config_flags(parser)
    parser.add_argument("--resume", type=int, default=0,
                        help="resume from the latest checkpoint in save_dir")
    parser.add_argument("--max_recoveries", type=int, default=3,
                        help="auto-resume from the last good checkpoint this "
                             "many times when training hits repeated "
                             "non-finite losses (0 = fail fast)")
    parser.add_argument("--eval_every", type=int, default=1,
                        help="epochs between eval passes (0 = off)")
    parser.add_argument("--max_eval_batches", type=int, default=16)
    parser.add_argument("--final_select_top", type=int, default=3,
                        help="at training end, re-evaluate the best N "
                             "epochs (by the subset per-epoch eval) on the "
                             "FULL held-out split and keep the winner in "
                             "best/ (0/1 = keep the running best)")
    parser.add_argument("--max_train_batches", type=int, default=0,
                        help="cap batches per epoch (0 = all; for smoke runs)")
    parser.add_argument("--platform", type=str, default="",
                        help="force a jax platform (e.g. cpu)")
    parser.add_argument("--profile_dir", type=str, default="",
                        help="capture a jax.profiler trace of epoch 0 into "
                             "this dir (view in Perfetto/TensorBoard)")
    parser.add_argument("--coordinator", type=str, default="",
                        help="multi-host: coordinator host:port "
                             "(jax.distributed); also set --num_processes "
                             "and --process_id")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    args = parser.parse_args(argv)
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if args.coordinator:
        mesh_mod.init_multihost(args.coordinator, args.num_processes,
                                args.process_id)
    cfg = config_from_args(args)
    train(cfg, resume=bool(args.resume), eval_every=args.eval_every,
          max_eval_batches=args.max_eval_batches,
          max_train_batches=args.max_train_batches or None,
          profile_dir=args.profile_dir or None,
          max_recoveries=args.max_recoveries,
          final_select_top=args.final_select_top)


def train(cfg: DesireConfig, resume: bool = False, eval_every: int = 1,
          max_eval_batches: int = 16, max_train_batches: int | None = None,
          profile_dir: str | None = None, max_recoveries: int = 3,
          final_select_top: int = 3):
    # multi-host: every process runs the data/step loop (collectives need
    # all of them); only process 0 logs, evaluates, and checkpoints
    is_main = jax.process_index() == 0
    log = MetricLogger(os.path.join(cfg.save_dir, "metrics.jsonl")
                       if (cfg.save_dir and is_main) else None,
                       quiet=not is_main)
    # train/test separation (VERDICT r2 #1): with holdout='video' (default)
    # training only ever sees the train split and periodic eval runs on the
    # held-out videos — `python train.py` reports out-of-sample numbers.
    split = "train" if cfg.holdout != "none" else None
    loader = SDDLoader(cfg, split=split)
    log.log({"event": "data", "split": split or "all",
             "videos": len(loader.videos),
             "windows": loader.num_windows, "batches": loader.num_batches})
    eval_loader, eval_held_out = loader, False
    if cfg.eval_scenes:
        # drop_remainder=False: eval must see every held-out window (a
        # small holdout can be smaller than one batch)
        eval_loader = SDDLoader(cfg.replace(scenes=cfg.eval_scenes,
                                            window_hop=cfg.eval_hop),
                                drop_remainder=False)
        eval_held_out = True
    elif cfg.holdout != "none":
        eval_loader = SDDLoader(cfg.replace(window_hop=cfg.eval_hop),
                                split="heldout", drop_remainder=False)
        eval_held_out = True
    if eval_loader is not loader:
        log.log({"event": "eval_data",
                 "videos": [v.name for v in eval_loader.videos],
                 "windows": eval_loader.num_windows})

    mesh = None
    if cfg.mesh_data * cfg.mesh_k > 1:
        mesh = mesh_mod.make_mesh(cfg.mesh_data, cfg.mesh_k)

    params = init_desire(jax.random.PRNGKey(cfg.seed), cfg)
    state = create_train_state(cfg, params, loader.num_batches)
    if cfg.save_dir and not resume:
        # refuse to train fresh into a dir holding a DIFFERENT run's
        # checkpoints: its steps would mix with this run's under retention
        # and the latest could restore with a tree mismatch (or worse,
        # silently wrong params). Same-config dirs are the auto-resume case
        # and are fine.
        old = ckpt_mod.load_config(cfg.save_dir)
        if old is not None and old != cfg and \
                ckpt_mod.CheckpointManager(cfg.save_dir).latest_step() is not None:
            raise SystemExit(
                f"save_dir {cfg.save_dir} holds checkpoints from a run with "
                "a different config; pass --resume to continue that run, or "
                "use a fresh --save_dir")
    mgr = ckpt_mod.CheckpointManager(cfg.save_dir) if cfg.save_dir else None
    # best-by-held-out selection: keep the checkpoint with the lowest
    # held-out minADE seen so far under <save_dir>/best (only meaningful
    # when eval runs on a held-out split — in-sample "best" would just be
    # the most-overfit state)
    best_mgr = None
    best_metric = float("inf")
    pool_mgr = None
    if mgr is not None and eval_every and eval_held_out and is_main:
        best_mgr = ckpt_mod.CheckpointManager(
            os.path.join(cfg.save_dir, "best"), keep=1)
        if final_select_top > 1:
            # candidate pool for end-of-training selection: the subset
            # (max_eval_batches) per-epoch eval picks WHICH epochs are
            # candidates; the final full-held-out pass picks best/ among
            # them, removing subset selection noise (VERDICT r4 item 8)
            pool_mgr = ckpt_mod.CheckpointManager(
                os.path.join(cfg.save_dir, "best_pool"),
                keep=final_select_top, keep_best_metric="minADE_px")

    start_epoch, start_batch = 0, 0
    if resume and mgr is not None:
        got = mgr.restore(state)
        if got is not None:
            state, lst = got
            start_epoch, start_batch = lst.epoch, lst.batch_index
            if start_batch >= loader.num_batches:
                start_epoch, start_batch = start_epoch + 1, 0
            log.log({"event": "resume", "step": int(state.step),
                     "epoch": start_epoch, "batch": start_batch})

    step_fn = trainer.make_train_step(cfg, loader.num_batches, mesh=mesh)

    save_interval = max(cfg.save_every // max(cfg.batch_size, 1), 1)
    recoveries = 0
    epoch = start_epoch
    while epoch < cfg.num_epochs:
        def log_fn(m, cur_state, _epoch=epoch):
            log.log(dict(m, event="train"))
            if mgr is not None and m["batch"] % save_interval == 0 and m["batch"] > 0:
                mgr.save(cur_state, loader.state, cfg)
        epoch_start = start_batch if epoch == start_epoch else 0
        try:
            if profile_dir and epoch == start_epoch:
                # trace a short slice of the first epoch (SURVEY §5 tracing
                # row); the main loop resumes AFTER the traced batches (they
                # took real optimizer steps — don't train them twice)
                traced = min(max_train_batches or 4, 4)
                with jax.profiler.trace(profile_dir):
                    state, _ = trainer.run_epoch(
                        state, loader, epoch, step_fn, log_fn=log_fn,
                        start_batch=epoch_start, mesh=mesh, max_batches=traced)
                log.log({"event": "profile", "dir": profile_dir})
                epoch_start += traced
            state, mean_loss = trainer.run_epoch(
                state, loader, epoch, step_fn, log_fn=log_fn,
                start_batch=epoch_start, mesh=mesh,
                max_batches=max_train_batches)
        except trainer.NonFiniteLossError as e:
            # failure recovery (SURVEY §5): roll back to the last good
            # checkpoint and continue — bounded by max_recoveries so a
            # deterministically-diverging run still fails loudly
            recoveries += 1
            if mgr is None or recoveries > max_recoveries:
                raise
            if jax.process_count() > 1:
                # only process 0 writes checkpoints; without a barrier a
                # non-zero process can race its restore against process 0's
                # flush (ADVICE r2)
                from jax.experimental import multihost_utils
                multihost_utils.sync_global_devices("pre_recovery_restore")
            got = mgr.restore(create_train_state(cfg, init_desire(
                jax.random.PRNGKey(cfg.seed), cfg), loader.num_batches))
            if got is None:
                raise
            state, lst = got
            start_epoch, start_batch = lst.epoch, lst.batch_index
            if start_batch >= loader.num_batches:
                start_epoch, start_batch = start_epoch + 1, 0
            log.log({"event": "recover", "error": str(e),
                     "recoveries": recoveries, "step": int(state.step),
                     "epoch": start_epoch, "batch": start_batch})
            epoch = start_epoch
            continue
        log.log({"event": "epoch", "epoch": epoch, "mean_loss": mean_loss})
        if mgr is not None:
            mgr.save(state, loader.state, cfg)
        if eval_every and (epoch + 1) % eval_every == 0 and is_main:
            ev = evaluate(state.params, cfg, eval_loader,
                          max_batches=max_eval_batches)
            log.log(dict(ev, event="eval", epoch=epoch,
                         held_out=eval_held_out))
            if best_mgr is not None and ev["minADE_px"] < best_metric:
                best_metric = ev["minADE_px"]
                best_mgr.save(state, loader.state, cfg)
                log.log({"event": "best", "epoch": epoch,
                         "minADE_px": best_metric})
            if pool_mgr is not None:
                pool_mgr.save(state, loader.state, cfg,
                              metrics={"minADE_px": float(ev["minADE_px"])})
        epoch += 1
    if pool_mgr is not None:
        _final_best_selection(cfg, pool_mgr, best_mgr, eval_loader,
                              loader.num_batches, log)
    return state


def _final_best_selection(cfg, pool_mgr, best_mgr, eval_loader,
                          steps_per_epoch, log):
    """Evaluate the subset-selected candidate epochs on the FULL held-out
    split and (re)write best/ with the winner (VERDICT r4 item 8: the
    per-epoch eval subsamples the split, so the running best/ can miss the
    true best epoch). Logs every candidate's full-split number so the
    subset-vs-full rank agreement is measured on every run."""
    import shutil

    steps = pool_mgr.all_steps()
    if not steps:
        return
    template = create_train_state(
        cfg, init_desire(jax.random.PRNGKey(cfg.seed), cfg), steps_per_epoch)
    rows = []
    for s in steps:
        got = pool_mgr.restore_step(s, template)
        if got is None:
            continue
        cand_state, _ = got
        ev = evaluate(cand_state.params, cfg, eval_loader, max_batches=None)
        rows.append((float(ev["minADE_px"]), s, cand_state))
        log.log({"event": "final_select_candidate", "step": s,
                 "minADE_px": float(ev["minADE_px"]),
                 "top1ADE_px": float(ev.get("top1ADE_px", -1.0))})
    if not rows:
        return
    rows.sort(key=lambda r: r[0])
    win_metric, win_step, win_state = rows[0]
    cur = best_mgr.latest_step() if best_mgr is not None else None
    log.log({"event": "final_select", "step": win_step,
             "minADE_px": win_metric, "replaced": cur != win_step,
             "prev_best_step": cur})
    # fit the top-1 score/typicality blend on a TRAIN-split slice with the
    # winner's params and persist it in the checkpoint config — eval and
    # serving then rank with it by default (VERDICT r4 item 2)
    cfg_out = cfg
    try:
        from desire.eval.sampler import fit_rank_blend
        fit_loader = SDDLoader(cfg.replace(window_hop=cfg.eval_hop),
                               split="train", drop_remainder=False)
        bl, diag = fit_rank_blend(win_state.params, cfg, fit_loader)
        cfg_out = cfg.replace(rank_blend_fit=float(bl))
        log.log(dict(diag, event="rank_blend_fit", blend=float(bl)))
    except Exception as e:  # the fit is an enhancement, never a run-killer
        log.log({"event": "rank_blend_fit", "error": str(e)})
    best_dir = os.path.join(cfg.save_dir, "best")
    if cur == win_step:
        # same checkpoint: only the config gains the fitted blend
        with open(os.path.join(best_dir, "config.json"), "w") as f:
            f.write(cfg_out.to_json())
        return
    # the winner differs from the running best: rewrite best/ (keep-latest
    # retention would drop a step older than the one there, so start the
    # dir fresh)
    shutil.rmtree(best_dir, ignore_errors=True)
    new_best = ckpt_mod.CheckpointManager(best_dir, keep=1)
    new_best.save(win_state, LoaderState(), cfg_out)


if __name__ == "__main__":
    main()
