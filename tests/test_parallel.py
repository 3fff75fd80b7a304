"""'Distributed without a cluster' tier (SURVEY §4): mesh construction,
sharded training steps, and parity between sharded and single-device
execution on the 8-virtual-CPU-device mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from desire.config import DesireConfig
from desire.models.desire import init_desire
from desire.parallel import mesh as mesh_mod
from desire.train import trainer
from desire.train.state import create_train_state


def small_cfg(**kw):
    base = dict(batch_size=8, max_num_obj=4, obs_len=4, pred_len=4,
                num_samples=4, d_dim=16, latent_size=8, embedding_size=8,
                channel_multiplier=10, scene_grid=8, scene_channels=4,
                num_refine=2, compute_dtype="float32", kld_warmup=0)
    base.update(kw)
    return DesireConfig(**base)


def _toy(cfg, key=0):
    b, a, t = cfg.batch_size, cfg.max_num_obj, cfg.total_len
    xy = jax.random.uniform(jax.random.PRNGKey(key), (b, t, a, 2)) * 0.5 + 0.2
    mask = jnp.ones((b, t, a))
    ids = jnp.arange(1, a + 1, dtype=jnp.float32)[None].repeat(b, 0)
    return xy, mask, ids


def test_make_mesh_shapes():
    m = mesh_mod.make_mesh(4, 2)
    assert m.axis_names == ("data", "k")
    assert m.devices.shape == (4, 2)
    m2 = mesh_mod.make_mesh(k=4)   # data inferred = 8/4
    assert m2.devices.shape == (2, 4)
    with pytest.raises(AssertionError):
        mesh_mod.make_mesh(16, 1)


def test_sharded_step_matches_single_device():
    """The dp+k sharded train step must produce the same loss/params as the
    unsharded one (same math, distributed)."""
    cfg = small_cfg()
    xy, mask, ids = _toy(cfg)

    # init twice (deterministic) — the train step donates its input state,
    # so the first step's params buffers are consumed
    s1 = create_train_state(cfg, init_desire(jax.random.PRNGKey(0), cfg), 10)
    f1 = trainer.make_train_step(cfg, 10)
    s1, m1 = f1(s1, xy, mask, ids)

    mesh = mesh_mod.make_mesh(4, 2)
    s2 = create_train_state(cfg, init_desire(jax.random.PRNGKey(0), cfg), 10)
    f2 = trainer.make_train_step(cfg, 10, mesh=mesh)
    sh = mesh_mod.batch_sharding(mesh)
    s2, m2 = f2(s2, jax.device_put(xy, sh), jax.device_put(mask, sh),
                jax.device_put(ids, sh))

    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(m1["grad_norm"]), float(m2["grad_norm"]),
                               rtol=1e-3)
    # Post-Adam params: loose atol — near-zero grads make Adam's normalized
    # update sensitive to fp reduction order (sharded vs not, and even
    # compile-cache ordering); loss and grad_norm above are the tight
    # discriminators. A real collective bug diverges far beyond this.
    l1 = jax.tree_util.tree_leaves(s1.params)
    l2 = jax.tree_util.tree_leaves(s2.params)
    for a, b in zip(l1, l2):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-3, atol=1e-3)


def test_sharded_grads_match_single_device_tight():
    """Raw grads (pre-Adam) under dp+k sharding vs one device, at tight
    tolerance — the discriminating collective-correctness check (the
    post-Adam comparison above is loosened by Adam's normalized update)."""
    from desire.models import desire

    cfg = small_cfg()
    xy, mask, ids = _toy(cfg)
    params = init_desire(jax.random.PRNGKey(0), cfg)
    key = jax.random.PRNGKey(7)

    def loss_fn(p, xy, mask, ids):
        return desire.desire_loss(p, cfg, xy, mask, ids, key=key, step=0)[0]

    g1 = jax.jit(jax.grad(loss_fn))(params, xy, mask, ids)

    mesh = mesh_mod.make_mesh(4, 2)
    bsh = mesh_mod.batch_sharding(mesh)
    rep = mesh_mod.replicated(mesh)
    g2 = jax.jit(jax.grad(loss_fn),
                 in_shardings=(rep, bsh, bsh, bsh),
                 out_shardings=rep)(
        jax.device_put(params, rep), jax.device_put(xy, bsh),
        jax.device_put(mask, bsh), jax.device_put(ids, bsh))

    flat1, tree1 = jax.tree_util.tree_flatten(g1)
    flat2, tree2 = jax.tree_util.tree_flatten(g2)
    assert tree1 == tree2
    for a, b in zip(flat1, flat2):
        scale = max(float(jnp.max(jnp.abs(a))), 1e-8)
        # atol floor 1e-7: near-zero leaves (e.g. dead gate biases) differ by
        # fp reduction-order noise that is meaningless in relative terms
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=max(1e-5 * scale, 1e-7))


def test_sharded_batch_is_actually_distributed():
    mesh = mesh_mod.make_mesh(8, 1)
    cfg = small_cfg()
    xy, _, _ = _toy(cfg)
    sharded = jax.device_put(xy, mesh_mod.batch_sharding(mesh))
    assert len(sharded.addressable_shards) == 8
    # each shard holds B/8 of the batch
    assert sharded.addressable_shards[0].data.shape[0] == cfg.batch_size // 8


def test_multi_step_training_on_mesh():
    cfg = small_cfg()
    mesh = mesh_mod.make_mesh(2, 4)   # heavier k-sharding
    params = init_desire(jax.random.PRNGKey(0), cfg)
    state = create_train_state(cfg, params, 10)
    step = trainer.make_train_step(cfg, 10, mesh=mesh)
    sh = mesh_mod.batch_sharding(mesh)
    losses = []
    for i in range(4):
        xy, mask, ids = _toy(cfg, key=i)
        state, m = step(state, jax.device_put(xy, sh),
                        jax.device_put(mask, sh), jax.device_put(ids, sh))
        losses.append(float(m["loss"]))
    assert all(np.isfinite(l) for l in losses)
    assert int(state.step) == 4


def test_graft_entry_single_chip():
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    traj, scores = out
    assert np.isfinite(np.asarray(traj, np.float32)).all()
    assert np.isfinite(np.asarray(scores, np.float32)).all()


def test_graft_entry_multichip_dryrun():
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)


@pytest.mark.parametrize("data,k", [(8, 1), (2, 4), (1, 8)])
def test_sharded_train_step_matches_single_device(data, k):
    """Loss and gradient norm of one train step agree between one device
    and each (data, k) mesh shape (k shards the hypothesis lanes)."""
    cfg = small_cfg(num_samples=8)
    xy, mask, ids = _toy(cfg)
    s1 = create_train_state(cfg, init_desire(jax.random.PRNGKey(0), cfg), 10)
    _, m1 = trainer.make_train_step(cfg, 10)(s1, xy, mask, ids)
    mesh = mesh_mod.make_mesh(data, k)
    sh = mesh_mod.batch_sharding(mesh)
    s2 = create_train_state(cfg, init_desire(jax.random.PRNGKey(0), cfg), 10)
    _, m2 = trainer.make_train_step(cfg, 10, mesh=mesh)(
        s2, *jax.device_put((xy, mask, ids), sh))
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(m1["grad_norm"]),
                               float(m2["grad_norm"]), rtol=1e-3)


@pytest.mark.parametrize("data,k", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_inference_matches_single_device(data, k):
    """The jitted inference forward under each (data, k) mesh draws the
    same lanes and refines them to the same trajectories as one device."""
    cfg = small_cfg(num_samples=8)
    xy, mask, ids = _toy(cfg, key=3)
    params = init_desire(jax.random.PRNGKey(1), cfg)
    key = jax.random.PRNGKey(5)
    one = trainer.make_eval_forward(cfg)(params, xy, mask, ids, key)
    mesh = mesh_mod.make_mesh(data, k)
    sh = mesh_mod.batch_sharding(mesh)
    out = trainer.make_eval_forward(cfg, mesh=mesh)(
        params, *jax.device_put((xy, mask, ids), sh), key)
    for name in ("refined_traj", "scores", "sgm_traj"):
        np.testing.assert_allclose(np.asarray(out[name]),
                                   np.asarray(one[name]), rtol=1e-5,
                                   atol=1e-5)


def test_sgm_sampler_shards_lanes_under_a_mesh():
    """The SGM sampler traced under a (data, k) mesh lays its K-lane
    outputs out over 'k' (the shard hints take effect) and draws the same
    hypotheses as without a mesh."""
    from desire.models import sgm

    cfg = small_cfg(num_samples=8)
    params = init_desire(jax.random.PRNGKey(0), cfg)["sgm"]
    n = cfg.batch_size * cfg.max_num_obj
    obs = jax.random.uniform(jax.random.PRNGKey(2), (n, cfg.obs_len, 2))
    obs_mask = jnp.ones((n, cfg.obs_len))
    key = jax.random.PRNGKey(4)

    def fn(p, o, m, key):
        out = sgm.sgm_forward(p, cfg, o, m, key=key, train=False)
        return out["traj_mu"], out["dec_h"]

    want = jax.jit(fn)(params, obs, obs_mask, key)
    mesh = mesh_mod.make_mesh(2, 4)
    got = mesh_mod.under_mesh(mesh, jax.jit(fn))(params, obs, obs_mask, key)
    assert got[0].sharding.spec[:2] == P("data", "k")
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


def test_make_mesh_keeps_device_order():
    devs = jax.devices()
    m = mesh_mod.make_mesh(2, 4, devs)
    assert [d.id for d in m.devices.ravel()] == [d.id for d in devs]
    m = mesh_mod.make_mesh(2, 2, devs[4:])
    assert [d.id for d in m.devices.ravel()] == [d.id for d in devs[4:8]]
