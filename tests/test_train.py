"""Integration tier (SURVEY §4): optimizer steps reduce loss on a micro
dataset; checkpoint/resume round-trips; eval metrics are correct.

The heavy pieces (model compile, loader) are module-scoped so the full-model
XLA compile happens once for all training tests."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from desire.config import DesireConfig
from desire.data.loader import SDDLoader
from desire.eval import metrics as M
from desire.eval.sampler import evaluate, make_sampler
from desire.models.desire import init_desire
from desire.train import checkpoint as ckpt_mod
from desire.train import trainer
from desire.train.state import create_train_state


def _micro_dataset(root, frames=90):
    """One synthetic video: agents moving on straight lines (learnable)."""
    rng = np.random.RandomState(0)
    recs = []
    for aid in range(1, 7):
        v = rng.uniform(-1.5, 1.5, 2)
        p0 = rng.uniform(20, 80, 2)
        for f in range(frames):
            p = p0 + v * f
            recs.append((f, aid, p[0], p[1]))
    arr = np.asarray(recs, dtype=np.float64).T
    path = os.path.join(str(root), "scene/video0/annotations_processed.csv")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for row in arr:
            f.write(",".join(f"{x:g}" for x in row) + "\n")
    return str(root)


def micro_cfg(data_dir, **kw):
    base = dict(batch_size=4, max_num_obj=8, obs_len=4, pred_len=4,
                subsample=2, window_hop=2, num_samples=3, d_dim=16,
                latent_size=8, embedding_size=8, channel_multiplier=10,
                scene_grid=8, scene_channels=4, num_refine=2,
                compute_dtype="float32", data_dir=data_dir, save_dir="",
                learning_rate=3e-3, kld_warmup=50, seed=0)
    base.update(kw)
    return DesireConfig(**base)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Shared dataset + loader + ONE compiled train step for all tests."""
    data_dir = _micro_dataset(tmp_path_factory.mktemp("micro"))
    cfg = micro_cfg(data_dir)
    loader = SDDLoader(cfg, use_native=False)
    step_fn = trainer.make_train_step(cfg, loader.num_batches)
    return {"cfg": cfg, "loader": loader, "step_fn": step_fn,
            "data_dir": data_dir}


def _fresh_state(env, seed=0):
    cfg, loader = env["cfg"], env["loader"]
    params = init_desire(jax.random.PRNGKey(seed), cfg)
    return create_train_state(cfg, params, loader.num_batches)


def test_train_step_decreases_loss(env):
    cfg, loader, step_fn = env["cfg"], env["loader"], env["step_fn"]
    state = _fresh_state(env)
    first, last = None, None
    for epoch in range(5):
        state, mean_loss = trainer.run_epoch(state, loader, epoch, step_fn)
        if first is None:
            first = mean_loss
        last = mean_loss
    assert np.isfinite(first) and np.isfinite(last)
    assert last < first - 1.0, f"no learning: first={first}, last={last}"


def test_input_norm_speed_balanced_loss():
    """Fast-agent features (config.py input_norm / speed_loss_alpha, the
    round-2 VERDICT's >20 px/step gap): scale-free encoding + class-balanced
    weighting must (1) keep loss/grads finite — including for a zero-speed
    agent, where the 1/(speed+floor) scale is the hazard, (2) upweight the
    fast agent relative to the walker (alpha>0 pulls the batch loss toward
    the worse fast-agent term), (3) train end-to-end."""
    from desire.models.desire import desire_loss
    cfg = micro_cfg("unused", use_ioc=False, use_scf=False, kld_warmup=1,
                    input_norm=True, speed_loss_alpha=1.0)
    params = init_desire(jax.random.PRNGKey(0), cfg)
    B, A = cfg.batch_size, cfg.max_num_obj
    T = cfg.obs_len + cfg.pred_len
    rng = np.random.default_rng(3)
    # agent 0 fast (12 px/step), agent 1 slow (0.5), agent 2 STATIONARY
    xy = np.zeros((B, T, A, 2), np.float32)
    for a, speed in enumerate([12.0, 0.5, 0.0] + [1.0] * (A - 3)):
        v = rng.standard_normal(2)
        v = speed * v / (np.linalg.norm(v) + 1e-9)
        p0 = rng.uniform(30, 70, 2)
        xy[:, :, a] = p0 + v * np.arange(T)[:, None]
    xy = jnp.asarray(xy)
    mask = jnp.ones((B, T, A))
    ids = jnp.tile(jnp.arange(1, A + 1)[None], (B, 1))
    key = jax.random.PRNGKey(1)

    loss, aux = desire_loss(params, cfg, xy, mask, ids, key=key, step=0)
    assert np.isfinite(float(loss))
    g = jax.grad(lambda p: desire_loss(p, cfg, xy, mask, ids,
                                       key=key, step=0)[0])(params)
    assert all(np.all(np.isfinite(np.asarray(x, np.float32)))
               for x in jax.tree_util.tree_leaves(g))

    # weighting property: under a fresh model the fast agent carries the
    # larger error, so upweighting it must raise the batch loss
    cfg0 = micro_cfg("unused", use_ioc=False, use_scf=False,
                     input_norm=True, speed_loss_alpha=0.0)
    loss0, _ = desire_loss(params, cfg0, xy, mask, ids, key=key, step=0)
    assert float(loss) > float(loss0), (
        f"alpha=1 did not upweight the fast agent: {loss} vs {loss0}")

    # a short training run must still learn
    state = create_train_state(cfg, params, steps_per_epoch=100)
    step_fn = trainer.make_train_step(cfg, 100)
    first = last = None
    for i in range(30):
        state, m = step_fn(state, xy, mask, ids)
        if first is None:
            first = float(m["loss"])
        last = float(m["loss"])
    assert np.isfinite(last) and last < first


def test_pace_head_zero_init_parity_and_trains():
    """pace_range (config.py): at init the zero-init pace head must leave
    the forward EXACTLY at the pace_range=0 composition; training with the
    head must stay finite and learn."""
    from desire.models.desire import desire_forward, desire_loss
    cfg0 = micro_cfg("unused", use_ioc=False, use_scf=False, kld_warmup=1)
    cfgp = cfg0.replace(pace_range=0.5)
    params = init_desire(jax.random.PRNGKey(0), cfgp)
    assert "pace" in params["sgm"]
    p0 = {**params, "sgm": {k: v for k, v in params["sgm"].items()
                            if k != "pace"}}
    B, A = cfg0.batch_size, cfg0.max_num_obj
    T = cfg0.obs_len + cfg0.pred_len
    rng = np.random.default_rng(7)
    xy = np.zeros((B, T, A, 2), np.float32)
    for b in range(B):
        for a in range(A):      # straight-line movers (learnable structure)
            v = rng.standard_normal(2) * 3.0
            xy[b, :, a] = rng.uniform(20, 80, 2) + v * np.arange(T)[:, None]
    xy = jnp.asarray(xy)
    mask = jnp.ones((B, T, A))
    ids = jnp.tile(jnp.arange(1, A + 1)[None], (B, 1))
    key = jax.random.PRNGKey(2)
    outp = desire_forward(params, cfgp, xy, mask, ids, key=key, train=True)
    out0 = desire_forward(p0, cfg0, xy, mask, ids, key=key, train=True)
    np.testing.assert_allclose(np.asarray(outp["raw5"]),
                               np.asarray(out0["raw5"]), atol=1e-6)

    state = create_train_state(cfgp, params, steps_per_epoch=100)
    step_fn = trainer.make_train_step(cfgp, 100)
    first = last = None
    for i in range(25):
        state, m = step_fn(state, xy, mask, ids)
        first = first if first is not None else float(m["loss"])
        last = float(m["loss"])
    assert np.isfinite(last) and last < first
    # the head is live: training moved it off exactly-zero
    w = np.asarray(state.params["sgm"]["pace"]["w"])
    assert np.abs(w).max() > 0


def test_pace_lanes_subset():
    """pace_lanes (config.py): with a NON-zero pace head, only the last n
    lanes move off the vanilla composition — the first K-n lanes must stay
    bitwise at the pace_range=0 trajectories (the oracle-cost bound the
    subset exists for)."""
    from desire.models import sgm
    cfg = micro_cfg("unused", use_ioc=False, use_scf=False,
                    pace_range=0.5, pace_lanes=2)
    params = init_desire(jax.random.PRNGKey(0), cfg)
    # force a non-trivial head so gated vs ungated lanes actually differ
    params["sgm"]["pace"]["w"] = 0.5 * jax.random.normal(
        jax.random.PRNGKey(3), params["sgm"]["pace"]["w"].shape)
    cv = jnp.ones((4, 2))
    dec_h = jax.random.normal(jax.random.PRNGKey(4),
                              (4, cfg.num_samples, 3, cfg.d_dim))
    cv_sub = sgm._lane_cv(params["sgm"], cfg, cv, dec_h)
    cv_all = sgm._lane_cv(params["sgm"], cfg.replace(pace_lanes=0), cv,
                          dec_h)
    k = cfg.num_samples
    # untouched lanes: exactly the vanilla CV base
    np.testing.assert_array_equal(np.asarray(cv_sub[:, : k - 2]),
                                  np.ones((4, k - 2, 2), np.float32))
    # gated lanes: exactly the full-pace composition
    np.testing.assert_array_equal(np.asarray(cv_sub[:, k - 2:]),
                                  np.asarray(cv_all[:, k - 2:]))
    assert float(np.abs(np.asarray(cv_all[:, : k - 2]) - 1.0).max()) > 1e-4


class _TransientFaultLoader:
    """Wraps a loader; serves NaN-poisoned batches for one whole epoch, once
    (a transient fault — e.g. a bad host read or a device glitch)."""

    def __init__(self, inner, poison_epoch):
        self._inner = inner
        self._poison_epoch = poison_epoch
        self._armed = True

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def epoch_batches(self, epoch, start_batch=0, rows=None):
        for b in self._inner.epoch_batches(epoch, start_batch, rows=rows):
            if self._armed and epoch == self._poison_epoch:
                b.xy = np.full_like(b.xy, np.nan)
            yield b
        if epoch == self._poison_epoch:
            self._armed = False   # fault clears after one pass


def test_fault_injection_auto_recovery(env, tmp_path, monkeypatch):
    """Failure detection + elastic recovery (SURVEY §5): a transient NaN
    fault must (1) be detected, (2) never reach a checkpoint, (3) be healed
    by auto-resume from the last good checkpoint — the run completes."""
    import json

    import train as train_mod

    cfg = env["cfg"].replace(save_dir=str(tmp_path / "ckpt"),
                             num_epochs=3, save_every=10_000)
    faulty = _TransientFaultLoader(SDDLoader(cfg, use_native=False),
                                   poison_epoch=1)
    monkeypatch.setattr(train_mod, "SDDLoader",
                        lambda c, **kw: faulty if not c.eval_scenes else
                        SDDLoader(c, **kw))
    train_mod.train(cfg, eval_every=0, max_recoveries=2)

    events = [json.loads(l) for l in
              open(os.path.join(cfg.save_dir, "metrics.jsonl"))]
    recov = [e for e in events if e["event"] == "recover"]
    assert len(recov) == 1, f"expected exactly one recovery, got {recov}"
    assert "non-finite" in recov[0]["error"]
    epochs = [e for e in events if e["event"] == "epoch"]
    # all 3 epochs completed with finite means (epoch 1 re-ran clean)
    assert sorted(e["epoch"] for e in epochs) == [0, 1, 2]
    assert all(np.isfinite(e["mean_loss"]) for e in epochs)
    # the surviving checkpoint holds finite params
    mgr = ckpt_mod.CheckpointManager(cfg.save_dir)
    got = mgr.restore(_fresh_state(env))
    assert got is not None
    assert all(np.isfinite(np.asarray(l)).all()
               for l in jax.tree_util.tree_leaves(got[0].params))


def test_scene_image_trains_and_changes_forward(env):
    """Real imagery through the scene CNN (VERDICT r4 item 7): with
    scene_image_channels=1 the loader-attached raster reaches the scene CNN
    (a different raster changes the refined trajectories), the train step
    consumes it, and the eval harness runs end-to-end."""
    from desire.models import desire as desire_mod

    cfg = micro_cfg(env["data_dir"], scene_image_channels=1)
    loader = SDDLoader(cfg, use_native=False)
    assert loader.scene_rasters is not None
    params = init_desire(jax.random.PRNGKey(0), cfg)
    batch = next(loader.epoch_batches(0))
    xy, mask, ids, img = trainer.batch_to_device(batch)
    key = jax.random.PRNGKey(1)
    out_a = desire_mod.desire_forward(params, cfg, xy, mask, ids, key=key,
                                      train=False, scene_image=img)
    out_b = desire_mod.desire_forward(params, cfg, xy, mask, ids, key=key,
                                      train=False, scene_image=1.0 - img)
    # the delta/gate heads are zero-init (refinement is identity at init),
    # so the raster's reach is visible in the IOC SCORES at a fresh init
    d = float(jnp.max(jnp.abs(out_a["scores"] - out_b["scores"])))
    assert d > 1e-6, "scene image does not reach the IOC scoring path"

    step_fn = trainer.make_train_step(cfg, loader.num_batches)
    state = create_train_state(cfg, params, loader.num_batches)
    state, metrics = step_fn(state, xy, mask, ids, img)
    assert np.isfinite(float(metrics["loss"]))
    # the donated step deleted the pre-step buffers: eval the NEW params
    res = evaluate(state.params, cfg, loader, max_batches=1)
    assert np.isfinite(res["minADE_px"])


def test_final_best_selection_full_split(env, tmp_path):
    """--final_select_top (VERDICT r4 item 8): training keeps a best-N
    candidate pool by the subset per-epoch eval, then re-evaluates the
    candidates on the FULL held-out split and best/ holds the full-split
    winner; every candidate's full number is logged (the measured
    subset-vs-full agreement)."""
    import json
    import shutil

    import train as train_mod

    # two identical videos in one scene -> holdout='video' holds out one
    data_dir = str(tmp_path / "data")
    shutil.copytree(os.path.join(env["data_dir"], "scene"),
                    os.path.join(data_dir, "scene"))
    shutil.copytree(os.path.join(env["data_dir"], "scene/video0"),
                    os.path.join(data_dir, "scene/video1"))
    cfg = micro_cfg(data_dir, save_dir=str(tmp_path / "ckpt"), num_epochs=3,
                    save_every=10_000, holdout="video")
    train_mod.train(cfg, eval_every=1, max_eval_batches=1,
                    final_select_top=2)

    events = [json.loads(l) for l in
              open(os.path.join(cfg.save_dir, "metrics.jsonl"))]
    cands = [e for e in events if e["event"] == "final_select_candidate"]
    final = [e for e in events if e["event"] == "final_select"]
    assert 1 <= len(cands) <= 2 and len(final) == 1
    assert all(np.isfinite(c["minADE_px"]) for c in cands)
    winner = min(cands, key=lambda c: c["minADE_px"])
    assert final[0]["step"] == winner["step"]
    # best/ restores and holds exactly the winner step
    best_mgr = ckpt_mod.CheckpointManager(os.path.join(cfg.save_dir, "best"))
    got = best_mgr.restore(_fresh_state(env))
    assert got is not None and int(got[0].step) == winner["step"]
    # the train-split-fitted rank blend is persisted in best/config.json
    # (VERDICT r4 item 2) and logged with its fit grid
    fit = [e for e in events if e["event"] == "rank_blend_fit"]
    assert len(fit) == 1 and "error" not in fit[0], fit
    from desire.train.checkpoint import load_config
    best_cfg = load_config(os.path.join(cfg.save_dir, "best"))
    assert best_cfg.rank_blend_fit == fit[0]["blend"] >= 0.0
    assert fit[0]["blends"][int(np.argmin(fit[0]["top1ADE_px"]))] \
        == fit[0]["blend"]


def test_nonfinite_epoch_raises_without_manager(env):
    """Without a checkpoint manager the failure must fail fast (raise), not
    silently return a NaN epoch mean."""
    cfg = env["cfg"]
    faulty = _TransientFaultLoader(env["loader"], poison_epoch=0)
    state = _fresh_state(env)
    with pytest.raises(trainer.NonFiniteLossError):
        trainer.run_epoch(state, faulty, 0, env["step_fn"])


def test_checkpoint_resume_roundtrip(env, tmp_path):
    cfg, loader, step_fn = env["cfg"], env["loader"], env["step_fn"]
    state = _fresh_state(env)
    state, _ = trainer.run_epoch(state, loader, 0, step_fn)

    mgr = ckpt_mod.CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(state, loader.state, cfg, wait=True)

    template = _fresh_state(env, seed=42)
    got = mgr.restore(template)
    assert got is not None
    restored, lst = got
    assert int(restored.step) == int(state.step)
    assert lst.epoch == loader.state.epoch
    for a, b in zip(jax.tree_util.tree_leaves(state.params),
                    jax.tree_util.tree_leaves(restored.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # restored PRNG stream continues identically
    k1 = jax.random.normal(jax.random.split(state.key)[1], (4,))
    k2 = jax.random.normal(jax.random.split(restored.key)[1], (4,))
    np.testing.assert_array_equal(np.asarray(k1), np.asarray(k2))
    # saved config round-trips
    assert ckpt_mod.load_config(str(tmp_path / "ckpt")).obs_len == cfg.obs_len
    # training continues from the restored state (same compiled step_fn)
    restored, loss = trainer.run_epoch(restored, loader, lst.epoch + 1, step_fn)
    assert np.isfinite(loss)
    assert int(restored.step) == int(state.step) + loader.num_batches


def _bimodal_batch(key, b=16, a=2, obs=4, fut=4):
    """Straight observed motion; future turns up OR down (unpredictable from
    the past). The optimal best-of-K strategy must spread hypotheses."""
    kd, = jax.random.split(key, 1)
    turn = jax.random.bernoulli(kd, shape=(b, a)).astype(jnp.float32) * 2 - 1
    t_obs = jnp.arange(obs, dtype=jnp.float32)
    t_fut = jnp.arange(1, fut + 1, dtype=jnp.float32)
    x_obs = 0.2 + 0.03 * t_obs
    x_fut = x_obs[-1] + 0.0 * t_fut
    y0 = 0.5
    xy = jnp.zeros((b, obs + fut, a, 2))
    xy = xy.at[:, :obs, :, 0].set(x_obs[None, :, None])
    xy = xy.at[:, :obs, :, 1].set(y0)
    xy = xy.at[:, obs:, :, 0].set(x_fut[None, :, None])
    y_fut = y0 + turn[:, None, :] * 0.04 * t_fut[None, :, None]
    xy = xy.at[:, obs:, :, 1].set(y_fut)
    mask = jnp.ones((b, obs + fut, a))
    ids = jnp.ones((b, a))
    return xy, mask, ids


def test_cvae_best_of_k_covers_bimodal_future():
    """Anti-collapse: with the variety (min-over-K) loss, the trained sampler
    must place hypotheses on BOTH modes of a bimodal future. Guards the
    dead-ReLU masking-head trap inherited from the reference
    (model/model.py:275-276) and posterior collapse generally."""
    # z_temp_learn pinned OFF: the learned speed->temperature head (round-4
    # default) legitimately shrinks spread up to its 3x floor on this
    # all-slow toy fixture, which sits right at the 1e-3 std threshold —
    # this test targets the dead-ReLU trap, not the temp head (the floor
    # itself is asserted in test_z_temp_head_bounded below)
    cfg = micro_cfg("unused", use_ioc=False, use_scf=False, obs_len=4,
                    pred_len=4, num_samples=4, batch_size=16, max_num_obj=2,
                    recon_agg="min", kld_free_bits=0.1, learning_rate=3e-3,
                    kld_warmup=100, z_temp_learn=False, w_prior_nll=0.0,
                    prior_lane_frac=0.0)
    params = init_desire(jax.random.PRNGKey(0), cfg)
    state = create_train_state(cfg, params, steps_per_epoch=1000)
    step_fn = trainer.make_train_step(cfg, 1000)
    for i in range(140):   # 90 sufficed pre-input_norm; the scale-free
        #                    encoding learns this fixture slightly slower
        xy, mask, ids = _bimodal_batch(jax.random.PRNGKey(100 + i))
        state, m = step_fn(state, xy, mask, ids)
    from desire.models.desire import desire_forward
    xy, mask, ids = _bimodal_batch(jax.random.PRNGKey(999))
    out = jax.jit(lambda p: desire_forward(
        p, cfg, xy, mask, ids, key=jax.random.PRNGKey(7), train=False))(
        state.params)
    traj = np.asarray(out["sgm_traj"], np.float32)        # (B, A, K, Tf, 2)
    lane_std = traj.std(axis=2).mean()
    assert lane_std > 1e-3, f"lanes collapsed: std={lane_std}"
    # diversity must pay on a bimodal future: best-of-K displacement beats
    # any single lane clearly (a collapsed sampler scores ratio ~1.0)
    gt = np.asarray(xy[:, cfg.obs_len:], np.float32).transpose(0, 2, 1, 3)
    err = np.linalg.norm(traj - gt[:, :, None], axis=-1).mean(-1)  # (B,A,K)
    min_ade = err.min(-1).mean()
    lane0_ade = err[..., 0].mean()
    ratio = min_ade / lane0_ade
    assert ratio < 0.85, f"best-of-K not better than single lane: {ratio:.2f}"


def test_z_temp_head_bounded():
    """The learned latent-temperature head (config.py z_temp_learn) is
    exactly 1 at zero-init and tanh-bounded to [1/3, 3] for ANY weights —
    lane diversity can shrink at most 3x, never collapse."""
    from desire.models.sgm import _learned_z_temp
    cfg = micro_cfg("unused", z_temp_learn=True, obs_len=4, pred_len=4,
                    max_num_obj=2)
    params = init_desire(jax.random.PRNGKey(0), cfg)["sgm"]
    assert "ztemp_fc1" in params
    rel = jax.random.normal(jax.random.PRNGKey(1), (6, cfg.obs_len, 2))
    m = jnp.ones((6, cfg.obs_len))
    t0 = _learned_z_temp(params, cfg, rel, m)
    np.testing.assert_allclose(np.asarray(t0), 1.0, atol=1e-6)
    hot = jax.tree.map(lambda w: jnp.full_like(w, 50.0), params)
    t_hot = np.asarray(_learned_z_temp(hot, cfg, rel * 100, m))
    cold = jax.tree.map(lambda w: jnp.full_like(w, -50.0), params)
    t_cold = np.asarray(_learned_z_temp(cold, cfg, rel * 0, m))
    for t in (t_hot, t_cold):
        assert (t >= 1.0 / 3 - 1e-5).all() and (t <= 3.0 + 1e-5).all(), t


def test_track_decomposition_closed_form():
    """GT moves along +x; a pure-x prediction offset must be along-track,
    a pure-y offset cross-track; a stationary GT contributes no
    decomposable steps (weight 0)."""
    from desire.eval.metrics import track_decomposition
    T = 4
    gt = np.zeros((1, 3, T, 2), np.float32)
    gt[0, :2, :, 0] = np.arange(T)            # agents 0,1 move along +x
    # agent 2 stays at the origin (no tangent)
    pred = np.repeat(gt[:, :, None], 2, axis=2)  # K=2 copies
    pred[0, 0, 0, :, 0] += 3.0                # agent 0 lane 0: +x offset
    pred[0, 0, 1] += 100.0                    # lane 1 far away (not min-ADE)
    pred[0, 1, 0, :, 1] += 2.0                # agent 1 lane 0: +y offset
    pred[0, 1, 1] += 100.0
    sm = np.ones((1, 3, T), np.float32)
    along, cross, w = jax.tree.map(
        np.asarray, track_decomposition(jnp.asarray(pred), jnp.asarray(gt),
                                        jnp.asarray(sm)))
    np.testing.assert_allclose(along[0, 0], 3.0, atol=1e-5)
    np.testing.assert_allclose(cross[0, 0], 0.0, atol=1e-5)
    np.testing.assert_allclose(along[0, 1], 0.0, atol=1e-5)
    np.testing.assert_allclose(cross[0, 1], 2.0, atol=1e-5)
    assert w[0, 0] == 1.0 and w[0, 1] == 1.0 and w[0, 2] == 0.0


def test_min_ade_fde_closed_form():
    # 1 batch, 2 agents, 2 hypotheses, 3 steps
    gt = jnp.zeros((1, 2, 3, 2))
    pred = jnp.zeros((1, 2, 2, 3, 2))
    pred = pred.at[0, 0, 0].set(1.0)      # agent0 hyp0: offset (1,1) each step
    pred = pred.at[0, 0, 1].set(2.0)      # agent0 hyp1: worse
    pred = pred.at[0, 1, 0].set(3.0)
    pred = pred.at[0, 1, 1, -1].set(1.0)  # agent1 hyp1: error only at last step
    sm = jnp.ones((1, 2, 3))
    am = jnp.ones((1, 2))
    ade, fde = M.min_ade_fde(pred, gt, sm, am)
    # agent0 best ADE = sqrt2; agent1 best = hyp1 with ADE sqrt2/3
    want_ade = (np.sqrt(2) + np.sqrt(2) / 3) / 2
    np.testing.assert_allclose(float(ade), want_ade, rtol=1e-5)
    # FDE: agent0 sqrt2, agent1 min(3*sqrt2 at last, sqrt2) = sqrt2
    np.testing.assert_allclose(float(fde), np.sqrt(2), rtol=1e-5)


def test_min_ade_fde_respects_step_mask():
    gt = jnp.zeros((1, 1, 4, 2))
    pred = jnp.zeros((1, 1, 1, 4, 2)).at[0, 0, 0, 3].set(9.0)  # err at step 3
    am = jnp.ones((1, 1))
    # step 3 masked out -> FDE at step 2 (last valid), err 0
    sm = jnp.array([[[1, 1, 1, 0]]], jnp.float32)
    ade, fde = M.min_ade_fde(pred, gt, sm, am)
    assert float(ade) == 0.0 and float(fde) == 0.0


def test_horizon_ade_fde_closed_form():
    """Fractional-horizon metrics: FDE at 1 s (= step 2.5 at 2.5 Hz) is the
    lerp of steps 2 and 3; ADE@1s averages the first floor(2.5)=2 steps."""
    t = 4
    gt = jnp.zeros((1, 1, t, 2))
    # one lane, constant x-error per step: [1, 2, 3, 4]
    pred = jnp.zeros((1, 1, 1, t, 2))
    pred = pred.at[0, 0, 0, :, 0].set(jnp.arange(1.0, t + 1))
    sm, am = jnp.ones((1, 1, t)), jnp.ones((1, 1))
    ade, fde, n = M.horizon_ade_fde(pred, gt, sm, am, horizon_steps=2.5)
    np.testing.assert_allclose(float(ade), (1 + 2) / 2, rtol=1e-6)
    np.testing.assert_allclose(float(fde), 2.5, rtol=1e-6)   # lerp(2, 3, .5)
    assert float(n) == 1
    # integer horizon degenerates to the plain step metric
    ade2, fde2, _ = M.horizon_ade_fde(pred, gt, sm, am, horizon_steps=3)
    np.testing.assert_allclose(float(fde2), 3.0, rtol=1e-6)
    # a masked step inside the horizon excludes the agent entirely
    sm_gap = jnp.array([[[1, 0, 1, 1]]], jnp.float32)
    _, _, n_gap = M.horizon_ade_fde(pred, gt, sm_gap, am, horizon_steps=2.5)
    assert float(n_gap) == 0


def test_pit_calibration_statistics():
    """PIT/coverage (north-star distribution-match evidence): ground truth
    drawn FROM the predicted Gaussians must be calibrated; an overconfident
    model (sigmas shrunk 5x) must under-cover."""
    rng = np.random.default_rng(0)
    b, a, k, t = 1, 1, 4, 4000
    mu = rng.normal(0, 1, (b, a, k, t, 2)).astype(np.float32)
    sigma = 0.7
    raw5 = np.concatenate([
        mu, np.full((b, a, k, t, 2), np.log(sigma), np.float32),
        np.zeros((b, a, k, t, 1), np.float32)], axis=-1)
    # draw gt from the uniform lane mixture
    lane = rng.integers(0, k, (b, a, t))
    picked = np.take_along_axis(mu, lane[..., None, :, None], axis=2)[:, :, 0]
    gt = picked + rng.normal(0, sigma, picked.shape).astype(np.float32)
    sm, am = jnp.ones((b, a, t)), jnp.ones((b, a))

    u, w = M.pit_values(jnp.asarray(raw5), jnp.asarray(gt), sm, am)
    cov = M.coverage(u, w)
    assert abs(cov[0.5] - 0.5) < 0.04, cov
    assert abs(cov[0.9] - 0.9) < 0.04, cov
    hist = np.asarray(M.pit_histogram(u, w, bins=10))
    p = hist / hist.sum()
    assert np.max(np.abs(np.cumsum(p) - np.linspace(0.1, 1.0, 10))) < 0.05

    # overconfident: same means, 5x smaller claimed sigma -> coverage drops
    raw5_oc = raw5.copy()
    raw5_oc[..., 2:4] = np.log(sigma / 5.0)
    u_oc, _ = M.pit_values(jnp.asarray(raw5_oc), jnp.asarray(gt), sm, am)
    cov_oc = M.coverage(u_oc, w)
    assert cov_oc[0.9] < 0.75, cov_oc

    # masked steps carry zero weight
    sm0 = sm.at[..., 0].set(0.0)
    _, w0 = M.pit_values(jnp.asarray(raw5), jnp.asarray(gt), sm0, am)
    assert float(jnp.sum(w0)) == b * a * (t - 1)


def test_sigma_temperature_fit_and_corrected_coverage(env):
    """Post-hoc calibration (VERDICT r3 item 9): pit_values' sigma_temp
    rescales the claimed sigmas (an overconfident model becomes calibrated
    at the true ratio), fit_sigma_temperature recovers a tau from data, and
    evaluate() reports exact corrected coverage at that tau."""
    # analytic half: heads claiming sigma/4 are calibrated at temp=4 exactly
    rng = np.random.default_rng(1)
    b, a, k, t = 1, 1, 4, 4000
    mu = rng.normal(0, 1, (b, a, k, t, 2)).astype(np.float32)
    sigma = 0.7
    raw5 = np.concatenate([
        mu, np.full((b, a, k, t, 2), np.log(sigma / 4.0), np.float32),
        np.zeros((b, a, k, t, 1), np.float32)], axis=-1)
    lane = rng.integers(0, k, (b, a, t))
    picked = np.take_along_axis(mu, lane[..., None, :, None], axis=2)[:, :, 0]
    gt = picked + rng.normal(0, sigma, picked.shape).astype(np.float32)
    sm, am = jnp.ones((b, a, t)), jnp.ones((b, a))
    u, w = M.pit_values(jnp.asarray(raw5), jnp.asarray(gt), sm, am,
                        sigma_temp=4.0)
    cov = M.coverage(u, w)
    assert abs(cov[0.5] - 0.5) < 0.04, cov
    u_raw, _ = M.pit_values(jnp.asarray(raw5), jnp.asarray(gt), sm, am)
    # raw heads under-cover (the K-lane spread keeps some mass central, so
    # the miss is moderate, but clearly below the corrected ~0.5)
    assert M.coverage(u_raw, w)[0.5] < 0.45

    # end-to-end half: fit on the micro loader, corrected keys reported
    from desire.eval.sampler import fit_sigma_temperature
    cfg, loader = env["cfg"], env["loader"]
    params = init_desire(jax.random.PRNGKey(0), cfg)
    from desire.eval.sampler import _FIT_TEMPS
    tau, diag = fit_sigma_temperature(params, cfg, loader, max_batches=2)
    assert _FIT_TEMPS[0] <= tau <= _FIT_TEMPS[-1]
    cov_grid = np.asarray(diag["coverage_50"])
    assert np.all(np.diff(cov_grid) >= -1e-6)  # coverage monotone in tau
    res = evaluate(params, cfg, loader, max_batches=2, calibration=True,
                   sigma_temps=(1.0, tau))
    cal = res["calibration"]
    assert {"sigma_temp", "coverage_50_cal", "coverage_90_cal",
            "pit_ks_cal"} <= set(cal)
    assert cal["sigma_temp"] == tau
    assert 0.0 <= cal["coverage_50_cal"] <= 1.0


def test_two_param_sigma_temperature(env):
    """(tau_center, tau_tail) calibration (VERDICT r4 item 6): when the
    truth is a two-scale mixture around the predicted means, NO scalar tau
    calibrates both the 50% and 90% intervals, but the matching pair does
    (pit_values' two-scale CDF then equals the true distribution), and the
    grid fit picks a pair that fixes both levels."""
    rng = np.random.default_rng(2)
    b, a, k, t = 1, 1, 4, 6000
    # nearly-coincident lanes: the per-lane noise SHAPE (not between-lane
    # spread) must dominate for the scalar-vs-pair distinction to bite
    mu = rng.normal(0, 0.05, (b, a, k, t, 2)).astype(np.float32)
    sigma = 0.7
    raw5 = np.concatenate([
        mu, np.full((b, a, k, t, 2), np.log(sigma), np.float32),
        np.zeros((b, a, k, t, 1), np.float32)], axis=-1)
    lane = rng.integers(0, k, (b, a, t))
    picked = np.take_along_axis(mu, lane[..., None, :, None], axis=2)[:, :, 0]
    # truth noise: equal mixture of a narrow (0.2 sigma) and a wide
    # (1.7 sigma) component -> the claimed N(mu, sigma) over-disperses the
    # center and under-disperses the tails simultaneously
    tc_true, tt_true = 0.2, 1.7
    wide = rng.random(picked.shape[:-1] + (1,)) < 0.5
    noise = np.where(wide, rng.normal(0, sigma * tt_true, picked.shape),
                     rng.normal(0, sigma * tc_true, picked.shape))
    gt = (picked + noise).astype(np.float32)
    sm, am = jnp.ones((b, a, t)), jnp.ones((b, a))

    # the matching pair calibrates BOTH levels
    u2, w = M.pit_values(jnp.asarray(raw5), jnp.asarray(gt), sm, am,
                         sigma_temp=(tc_true, tt_true))
    cov2 = M.coverage(u2, w)
    assert abs(cov2[0.5] - 0.5) < 0.04, cov2
    assert abs(cov2[0.9] - 0.9) < 0.04, cov2

    # every scalar tau on the fit grid misses at least one level by more
    from desire.eval.sampler import _FIT_TEMPS
    worst_best = 1e9
    for tau in _FIT_TEMPS:
        us, _ = M.pit_values(jnp.asarray(raw5), jnp.asarray(gt), sm, am,
                             sigma_temp=float(tau))
        cs = M.coverage(us, w)
        worst_best = min(worst_best,
                         max(abs(cs[0.5] - 0.5), abs(cs[0.9] - 0.9)))
    assert worst_best > 0.05, worst_best

    # end-to-end: the two-param fit runs on the micro loader and evaluate()
    # reports the pair + exact corrected coverage keys
    from desire.eval.sampler import fit_sigma_temperature
    cfg, loader = env["cfg"], env["loader"]
    params = init_desire(jax.random.PRNGKey(0), cfg)
    pairs = ((0.2, 1.0), (0.5, 1.4), (1.0, 1.0))  # tiny grid: CPU test
    tau, diag = fit_sigma_temperature(params, cfg, loader, max_batches=1,
                                      two_param=True, temps=pairs)
    assert isinstance(tau, tuple) and len(tau) == 2
    assert list(tau) in [list(p) for p in pairs]
    assert len(diag["coverage_50"]) == len(pairs)
    assert len(diag["coverage_90"]) == len(pairs)
    res = evaluate(params, cfg, loader, max_batches=1, calibration=True,
                   sigma_temps=(1.0, tau))
    cal = res["calibration"]
    assert cal["sigma_temp"] == list(tau)
    assert 0.0 <= cal["coverage_90_cal"] <= 1.0


def test_config_absent_keys_keep_save_time_behavior():
    """ADVICE r4 (medium): a key absent from a saved config.json means the
    checkpoint PREDATES the feature — from_json must resolve it to the
    pre-feature behavior (off), not today's default, or the checkpoint
    restore template gains param leaves the saved tree lacks (z_temp_learn et al.)
    and every older checkpoint fails to restore."""
    import json as _json
    from desire.config import DesireConfig, _PRE_FEATURE_DEFAULTS
    cfg = DesireConfig()
    d = _json.loads(cfg.to_json())
    for k in _PRE_FEATURE_DEFAULTS:
        del d[k]
    old = DesireConfig.from_json(_json.dumps(d))
    for k, legacy in _PRE_FEATURE_DEFAULTS.items():
        assert getattr(old, k) == legacy, k
    # present keys are honored verbatim (no blanket override)
    assert DesireConfig.from_json(cfg.to_json()).z_temp_learn \
        == cfg.z_temp_learn


def test_best_of_k_by_score():
    pred = jnp.stack([jnp.zeros((1, 1, 3, 2)), jnp.ones((1, 1, 3, 2))],
                     axis=2)  # (1,1,2,3,2)
    scores = jnp.array([[[0.1, 5.0]]])
    best = M.best_of_k_by_score(pred, scores)
    np.testing.assert_array_equal(np.asarray(best), np.ones((1, 1, 3, 2)))


def test_best_of_k_by_score_typicality_blend():
    """rank_blend: a large typicality weight must switch the pick from a
    high-scored OUTLIER lane to a central one; blend=0 keeps pure score."""
    # K=3: lanes 1,2 cluster at ~1.0; lane 0 is a far outlier with top score
    pred = jnp.stack([jnp.full((1, 1, 4, 2), 50.0),
                      jnp.full((1, 1, 4, 2), 1.0),
                      jnp.full((1, 1, 4, 2), 1.1)], axis=2)   # (1,1,3,4,2)
    scores = jnp.array([[[5.0, 4.0, 3.0]]])
    pure = M.best_of_k_by_score(pred, scores)
    np.testing.assert_allclose(np.asarray(pure)[0, 0, 0, 0], 50.0)
    blended = M.best_of_k_by_score(pred, scores, blend=5.0)
    assert float(np.asarray(blended)[0, 0, 0, 0]) < 2.0


def test_evaluate_harness_runs(env):
    cfg, loader = env["cfg"], env["loader"]
    params = init_desire(jax.random.PRNGKey(0), cfg)
    # micro protocol rate = 30/subsample = 15 Hz, pred_len 4 -> horizons
    # must sit inside 0.267 s
    res = evaluate(params, cfg, loader, max_batches=2, per_scene=True,
                   horizons=(0.1, 0.2), calibration=True, speed_bins=(2, 8))
    assert np.isfinite(res["minADE_px"]) and np.isfinite(res["minFDE_px"])
    assert res["minADE_px"] <= res["top1ADE_px"] + 1e-6  # oracle <= ranked
    assert res["num_agents"] > 0
    # optional breakdowns all populated by the fused eval step
    assert res["per_scene"] and all(
        np.isfinite(v["minADE_px"]) for v in res["per_scene"].values())
    assert "0.1s" in res["horizons"]
    h1, h2 = res["horizons"]["0.1s"], res["horizons"]["0.2s"]
    assert h1["minADE_px"] <= h2["minADE_px"] + 1e-6     # errors grow with h
    assert abs(h1["minADE_px_fifth"] * 5 - h1["minADE_px"]) < 1e-6
    assert 0 <= res["calibration"]["pit_ks"] <= 1
    assert res["speed_classes"]
    # scene/speed groups partition the same weighted agent population
    assert abs(sum(v["num_agents"] for v in res["per_scene"].values())
               - res["num_agents"]) < 1e-3
    assert abs(sum(v["num_agents"] for v in res["speed_classes"].values())
               - res["num_agents"]) < 1e-3


def test_evaluate_matches_direct_metrics(env):
    """The fused single-dispatch eval step reproduces the straightforward
    per-batch metric math (make_sampler + min_ade_fde) exactly."""
    cfg, loader = env["cfg"], env["loader"]
    params = init_desire(jax.random.PRNGKey(0), cfg)
    res = evaluate(params, cfg, loader, max_batches=2)

    sampler = make_sampler(cfg)
    key = jax.random.PRNGKey(cfg.seed + 1)
    num, den = 0.0, 0.0
    for bi, batch in enumerate(loader.epoch_batches(0)):
        if bi >= 2:
            break
        xy, mask, ids = trainer.batch_to_device(batch)
        key, sub = jax.random.split(key)
        out = sampler(params, xy, mask, ids, sub)
        live = (out["live"].astype(jnp.float32)
                * (jnp.sum(out["fut_mask"], axis=-1) > 0))
        a, _ = M.min_ade_fde(out["traj"].astype(jnp.float32),
                             out["fut_xy"].astype(jnp.float32),
                             out["fut_mask"].astype(jnp.float32),
                             live, scale=jnp.asarray(batch.scale))
        num += float(a) * float(jnp.sum(live))
        den += float(jnp.sum(live))
    np.testing.assert_allclose(res["minADE_px"], num / den, rtol=1e-5)


def test_stochastic_sampler_differs_from_mean(env):
    cfg, loader = env["cfg"], env["loader"]
    params = init_desire(jax.random.PRNGKey(0), cfg)
    b = loader.materialize(4)
    xy, mask, ids = trainer.batch_to_device(b)
    det = make_sampler(cfg)(params, xy, mask, ids, jax.random.PRNGKey(5))
    sto = make_sampler(cfg, stochastic=True)(params, xy, mask, ids,
                                             jax.random.PRNGKey(5))
    assert not np.allclose(np.asarray(det["traj"]), np.asarray(sto["traj"]))


def test_rollout_long_horizon(env):
    """Autoregressive rollout (reference sample() feed-back analogue):
    chunked prediction extends the horizon; observed part is preserved."""
    from desire.eval.sampler import make_rollout
    cfg, loader = env["cfg"], env["loader"]
    params = init_desire(jax.random.PRNGKey(0), cfg)
    b = loader.materialize(3)
    xy, mask, ids = trainer.batch_to_device(b)
    obs_xy = jnp.swapaxes(xy[:, :cfg.obs_len], 1, 2)
    obs_mask = jnp.swapaxes(mask[:, :cfg.obs_len], 1, 2)
    roll = make_rollout(cfg)
    out = roll(params, obs_xy, obs_mask, ids, jax.random.PRNGKey(1),
               num_chunks=3)
    assert out.shape == (3, cfg.max_num_obj,
                         cfg.obs_len + 3 * cfg.pred_len, 2)
    np.testing.assert_allclose(np.asarray(out[:, :, :cfg.obs_len]),
                               np.asarray(obs_xy), rtol=1e-5)
    assert np.isfinite(np.asarray(out, np.float32)).all()


def test_dump_trajectories(env, tmp_path):
    from desire.eval.sampler import dump_trajectories
    cfg, loader = env["cfg"], env["loader"]
    params = init_desire(jax.random.PRNGKey(0), cfg)
    path = str(tmp_path / "dump.npz")
    n = dump_trajectories(params, cfg, loader, path, num_batches=2)
    assert n > 0
    d = np.load(path)
    b, a, to = n, cfg.max_num_obj, cfg.obs_len
    assert d["obs_xy"].shape == (b, a, to, 2)
    assert d["traj"].shape == (b, a, cfg.num_samples, cfg.pred_len, 2)
    assert d["scores"].shape == (b, a, cfg.num_samples)
    assert d["best"].shape == (b, a, cfg.pred_len, 2)
    assert d["video"].shape == (b,) and d["scale"].shape == (b,)
    # the ranked best is one of the K hypotheses
    i = int(np.argmax(d["live"][0]))
    diffs = np.abs(d["traj"][0, i] - d["best"][0, i][None]).max(axis=(1, 2))
    assert diffs.min() < 1e-5
    # every array must round-trip through npz as a REAL numpy dtype —
    # bf16 model outputs (e.g. scores) silently became 2-byte void ('V2')
    # before the writer's f32 cast, poisoning every downstream reader
    for k in d.files:
        assert d[k].dtype.kind in "iuf", (k, d[k].dtype)


def test_dump_trajectories_bf16(env, tmp_path):
    """The dump writer's f32 cast exercised with actual bf16 outputs."""
    from desire.eval.sampler import dump_trajectories
    cfg, loader = env["cfg"], env["loader"]
    cfg = cfg.replace(compute_dtype="bfloat16")
    params = init_desire(jax.random.PRNGKey(0), cfg)
    path = str(tmp_path / "dump16.npz")
    assert dump_trajectories(params, cfg, loader, path, num_batches=1) > 0
    d = np.load(path)
    for k in d.files:
        assert d[k].dtype.kind in "iuf", (k, d[k].dtype)
    assert np.isfinite(d["scores"]).all()


def test_visualize_renders_pngs(tmp_path):
    """visualize.py end-to-end on a synthetic dump (no model needed)."""
    import subprocess
    import sys
    rng = np.random.default_rng(0)
    n, a, to, tf_len, k = 3, 4, 8, 12, 5
    dump = str(tmp_path / "d.npz")
    np.savez(dump,
             obs_xy=rng.uniform(0.2, 0.8, (n, a, to, 2)).astype(np.float32),
             obs_mask=np.ones((n, a, to), np.float32),
             fut_xy=rng.uniform(0.2, 0.8, (n, a, tf_len, 2)).astype(np.float32),
             fut_mask=np.ones((n, a, tf_len), np.float32),
             traj=rng.uniform(0.2, 0.8, (n, a, k, tf_len, 2)).astype(np.float32),
             scores=rng.normal(size=(n, a, k)).astype(np.float32),
             best=rng.uniform(0.2, 0.8, (n, a, tf_len, 2)).astype(np.float32),
             live=np.ones((n, a), np.float32),
             video=np.zeros((n,), np.int32),
             scale=np.full((n,), 100.0, np.float32))
    out = str(tmp_path / "figs")
    r = subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(__file__), "..",
                                      "visualize.py"),
         dump, "--out", out, "--windows", "2", "--dpi", "60"],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    pngs = [f for f in os.listdir(out) if f.endswith(".png")]
    assert len(pngs) == 2


def test_speed_aug_train_step_runs_and_differs(env):
    """speed_aug > 0 (global window-zoom augmentation) must keep the train
    step finite and actually change the computed loss vs the unaugmented
    step from the same state/batch (the zoom is applied pre-loss)."""
    b = next(iter(env["loader"].epoch_batches(0)))
    xy, mask, ids = (jnp.asarray(b.xy), jnp.asarray(b.mask),
                     jnp.asarray(b.ids))
    state0 = _fresh_state(env)
    _, m_plain = env["step_fn"](state0, xy, mask, ids)

    cfg_aug = micro_cfg(env["data_dir"], speed_aug=0.3)
    step_aug = trainer.make_train_step(cfg_aug, 100)
    state1 = _fresh_state(env)
    _, m_aug = step_aug(state1, xy, mask, ids)
    assert np.isfinite(float(m_aug["loss"]))
    assert float(m_aug["loss"]) != float(m_plain["loss"])
