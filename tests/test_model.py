"""Model tier: layer correctness vs independent references, SGM/IOC shapes,
mask invariance, gradient health (SURVEY.md §4)."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from desire.config import DesireConfig
from desire.models import desire, layers, losses, scf, sgm


def tiny_cfg(**kw):
    base = dict(batch_size=2, max_num_obj=4, obs_len=4, pred_len=3,
                num_samples=3, d_dim=16, latent_size=8, embedding_size=8,
                channel_multiplier=10, scene_grid=8, scene_channels=4,
                num_refine=2, compute_dtype="float32", kld_warmup=0)
    base.update(kw)
    return DesireConfig(**base)


# -- layers -------------------------------------------------------------------

def test_gru_matches_flax_grucell():
    """Our fused-gate GRU must match flax's GRUCell exactly (same variant)."""
    key = jax.random.PRNGKey(0)
    in_dim, hidden, n, t = 6, 5, 3, 7
    p = layers.init_gru(key, in_dim, hidden)
    cell = fnn.GRUCell(features=hidden)
    # translate our params into flax's: flax GRUCell uses dense_i (ir,iz,in)
    # and dense_h (hr,hz,hn) with bias only on i-gates and the n h-gate.
    wi = np.asarray(p["wi"]); wh = np.asarray(p["wh"])
    fvars = {"params": {
        "ir": {"kernel": wi[:, :hidden], "bias": np.asarray(p["bi"][:hidden])},
        "iz": {"kernel": wi[:, hidden:2*hidden], "bias": np.asarray(p["bi"][hidden:2*hidden])},
        "in": {"kernel": wi[:, 2*hidden:], "bias": np.asarray(p["bi"][2*hidden:])},
        "hr": {"kernel": wh[:, :hidden]},
        "hz": {"kernel": wh[:, hidden:2*hidden]},
        "hn": {"kernel": wh[:, 2*hidden:], "bias": np.asarray(p["bh"][2*hidden:])},
    }}
    # our bh applies to all three h-gates; zero r,z parts for equivalence
    p = dict(p, bh=p["bh"].at[:2*hidden].set(0.0))
    xs = jax.random.normal(jax.random.PRNGKey(1), (t, n, in_dim))
    h = jnp.zeros((n, hidden))
    h_flax = h
    for step in range(t):
        h = layers.gru_step(p, h, xs[step])
        h_flax, _ = cell.apply(fvars, h_flax, xs[step])
        np.testing.assert_allclose(np.asarray(h), np.asarray(h_flax),
                                   rtol=2e-5, atol=2e-5)


def test_gru_scan_const_x_matches_generic_scan():
    """The hoisted constant-input decoder scan must be bit-identical to the
    generic scan fed the broadcast seed (pure refactor, no math change)."""
    p = layers.init_gru(jax.random.PRNGKey(0), 16, 16)
    h0 = jax.random.normal(jax.random.PRNGKey(1), (6, 16))
    x = jax.random.normal(jax.random.PRNGKey(2), (6, 16))
    t = 7
    hT1, hs1 = layers.gru_scan(p, h0, jnp.broadcast_to(x, (t, 6, 16)))
    hT2, hs2 = layers.gru_scan_const_x(p, h0, x, t)
    np.testing.assert_array_equal(np.asarray(hs1), np.asarray(hs2))
    np.testing.assert_array_equal(np.asarray(hT1), np.asarray(hT2))


def test_gru_scan_mask_freezes_state():
    p = layers.init_gru(jax.random.PRNGKey(0), 3, 4)
    xs = jax.random.normal(jax.random.PRNGKey(1), (5, 2, 3))
    mask = jnp.array([[1, 1], [0, 1], [1, 1], [0, 0], [1, 1]], jnp.float32)
    h0 = jnp.zeros((2, 4))
    hT, hs = layers.gru_scan(p, h0, xs, mask=mask)
    # row 0 masked at steps 1,3: state at step1 == state at step0
    np.testing.assert_array_equal(np.asarray(hs[1, 0]), np.asarray(hs[0, 0]))
    np.testing.assert_array_equal(np.asarray(hs[3, 0]), np.asarray(hs[2, 0]))
    assert not np.allclose(np.asarray(hs[1, 1]), np.asarray(hs[0, 1]))


def test_conv_deconv_geometry():
    """The conv-VAE stacks must reproduce the reference geometry
    (32x32 -> 4x4x128 -> latent; z -> 32x32, model/model.py:453-492)."""
    key = jax.random.PRNGKey(0)
    cfg = DesireConfig(vae_dec="conv")   # the reference deconv decoder path
    p = sgm.init_sgm(key, cfg)
    assert "vdec1" in p      # conv decoder actually selected
    hx = jnp.zeros((2, cfg.d_dim)); hy = jnp.zeros((2, cfg.d_dim))
    mu, logvar = sgm.vae_encode(p, hx, hy, cfg.vae_side)
    assert mu.shape == (2, cfg.latent_size) == logvar.shape
    beta, recon = sgm.vae_decode_mask(p, jnp.zeros((2, cfg.latent_size)),
                                      cfg.vae_side)
    assert recon.shape == (2, cfg.vae_input_size)
    assert beta.shape == (2, cfg.d_dim)
    # mean-1 gate: softmax rescaled by d (see vae_decode_mask docstring)
    np.testing.assert_allclose(np.asarray(beta.sum(-1)), cfg.d_dim, rtol=1e-4)


def test_groupnorm_normalizes():
    p = layers.init_groupnorm(8)
    x = jax.random.normal(jax.random.PRNGKey(0), (4, 6, 6, 8)) * 5 + 3
    y = layers.groupnorm(p, x, groups=4)
    flat = np.asarray(y).reshape(4, -1)
    assert abs(flat.mean()) < 0.1 and abs(flat.std() - 1.0) < 0.1


# -- SGM ----------------------------------------------------------------------

def test_sgm_shapes_and_determinism():
    cfg = tiny_cfg(rnn_size=512)
    key = jax.random.PRNGKey(0)
    p = sgm.init_sgm(key, cfg)
    n, to, tf, K = 6, cfg.obs_len, cfg.pred_len, cfg.num_samples
    obs = jax.random.normal(jax.random.PRNGKey(1), (n, to, 2)) * 0.1 + 0.5
    fut = jax.random.normal(jax.random.PRNGKey(2), (n, tf, 2)) * 0.1 + 0.5
    m_o, m_f = jnp.ones((n, to)), jnp.ones((n, tf))
    out = sgm.sgm_forward(p, cfg, obs, m_o, fut, m_f,
                          key=jax.random.PRNGKey(3), train=True)
    assert out["raw5"].shape == (n, K, tf, 5)
    assert out["traj_mu"].shape == (n, K, tf, 2)
    assert out["z_mu"].shape == (n, cfg.latent_size)
    assert out["rho"].shape == (n, 2 * cfg.channel_multiplier)
    # same key -> identical; different key -> different (stochastic z)
    out2 = sgm.sgm_forward(p, cfg, obs, m_o, fut, m_f,
                           key=jax.random.PRNGKey(3), train=True)
    np.testing.assert_array_equal(np.asarray(out["traj_mu"]),
                                  np.asarray(out2["traj_mu"]))
    out3 = sgm.sgm_forward(p, cfg, obs, m_o, fut, m_f,
                           key=jax.random.PRNGKey(4), train=True)
    assert not np.array_equal(np.asarray(out["traj_mu"]),
                              np.asarray(out3["traj_mu"]))
    # K lanes differ from each other (distinct eps per lane)
    lanes = np.asarray(out["traj_mu"])
    assert not np.allclose(lanes[:, 0], lanes[:, 1])


def test_sgm_inference_mode_needs_no_future():
    cfg = tiny_cfg()
    p = sgm.init_sgm(jax.random.PRNGKey(0), cfg)
    n = 4
    obs = jnp.ones((n, cfg.obs_len, 2)) * 0.5
    out = sgm.sgm_forward(p, cfg, obs, jnp.ones((n, cfg.obs_len)),
                          key=jax.random.PRNGKey(1), train=False)
    assert out["z_mu"] is None
    assert out["traj_mu"].shape == (n, cfg.num_samples, cfg.pred_len, 2)


def test_prior_lane_frac_lanes_ignore_the_future():
    """prior_lane_frac (config.py): the first round(K*frac) train-time lanes
    draw z from the prior, which conditions on the PAST only — perturbing
    the future trajectory must leave those lanes bit-identical while the
    remaining (posterior/recognition) lanes move."""
    cfg = tiny_cfg(prior_lane_frac=0.5)
    p = sgm.init_sgm(jax.random.PRNGKey(0), cfg)
    n, K = 4, cfg.num_samples
    kp = int(round(K * cfg.prior_lane_frac))
    assert 0 < kp < K, "tiny cfg must exercise a mixed prior/posterior split"
    obs = jax.random.normal(jax.random.PRNGKey(1), (n, cfg.obs_len, 2)) * 0.1 + 0.5
    fut = jax.random.normal(jax.random.PRNGKey(2), (n, cfg.pred_len, 2)) * 0.1 + 0.5
    m_o, m_f = jnp.ones((n, cfg.obs_len)), jnp.ones((n, cfg.pred_len))
    kw = dict(key=jax.random.PRNGKey(3), train=True)
    t1 = np.asarray(sgm.sgm_forward(p, cfg, obs, m_o, fut, m_f, **kw)["traj_mu"])
    t2 = np.asarray(sgm.sgm_forward(p, cfg, obs, m_o, fut + 0.1, m_f, **kw)["traj_mu"])
    np.testing.assert_array_equal(t1[:, :kp], t2[:, :kp])
    assert not np.allclose(t1[:, kp:], t2[:, kp:])


def test_z_temp_learn_identity_at_init_then_trains_and_spreads():
    """z_temp_learn (config.py): the zero-init head makes temp exactly 1, so
    flag-on forwards (train AND inference) are bit-identical to flag-off with
    the same key; with prior_lane_frac > 0 the full loss gives the head a
    nonzero gradient; a pushed-up head changes inference lanes (spread)."""
    kw = dict(prior_lane_frac=0.5)
    cfg_on, cfg_off = tiny_cfg(z_temp_learn=True, **kw), tiny_cfg(**kw)
    p_on = sgm.init_sgm(jax.random.PRNGKey(0), cfg_on)
    p_off = sgm.init_sgm(jax.random.PRNGKey(0), cfg_off)
    assert "ztemp_fc1" in p_on
    # fold_in'd head keys: every shared param must be identical
    for k in p_off:
        for a, b in zip(jax.tree_util.tree_leaves(p_on[k]),
                        jax.tree_util.tree_leaves(p_off[k])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    n = 4
    obs = jax.random.normal(jax.random.PRNGKey(1), (n, cfg_on.obs_len, 2)) * 0.1 + 0.5
    fut = jax.random.normal(jax.random.PRNGKey(2), (n, cfg_on.pred_len, 2)) * 0.1 + 0.5
    m_o, m_f = jnp.ones((n, cfg_on.obs_len)), jnp.ones((n, cfg_on.pred_len))
    for branch_kw in (dict(fut_xy=fut, fut_mask=m_f, train=True),
                      dict(train=False)):
        t_on = sgm.sgm_forward(p_on, cfg_on, obs, m_o,
                               key=jax.random.PRNGKey(3), **branch_kw)
        t_off = sgm.sgm_forward(p_off, cfg_off, obs, m_o,
                                key=jax.random.PRNGKey(3), **branch_kw)
        np.testing.assert_array_equal(np.asarray(t_on["traj_mu"]),
                                      np.asarray(t_off["traj_mu"]))
    # gradient reaches the head through the variety NLL + IOC CE
    params = desire.init_desire(jax.random.PRNGKey(0), cfg_on)
    xy = jax.random.uniform(jax.random.PRNGKey(2),
                            (cfg_on.batch_size, cfg_on.total_len,
                             cfg_on.max_num_obj, 2)) * 0.5 + 0.2
    mask = jnp.ones(xy.shape[:3])
    ids = jnp.arange(1, cfg_on.max_num_obj + 1,
                     dtype=jnp.float32)[None].repeat(cfg_on.batch_size, 0)
    (_, _), grads = jax.value_and_grad(
        lambda p: desire.desire_loss(p, cfg_on, xy, mask, ids,
                                     key=jax.random.PRNGKey(3), step=0),
        has_aux=True)(params)
    g = grads["sgm"]["ztemp_fc2"]["w"]
    assert np.isfinite(np.asarray(g)).all() and np.abs(np.asarray(g)).max() > 0
    # a pushed-up head actually spreads inference hypotheses
    p_hot = dict(p_on, ztemp_fc2={"w": p_on["ztemp_fc2"]["w"],
                                  "b": p_on["ztemp_fc2"]["b"] + 5.0})
    t_init = sgm.sgm_forward(p_on, cfg_on, obs, m_o,
                             key=jax.random.PRNGKey(3), train=False)["traj_mu"]
    t_hot = sgm.sgm_forward(p_hot, cfg_on, obs, m_o,
                            key=jax.random.PRNGKey(3), train=False)["traj_mu"]
    sp = lambda t: float(np.mean(np.var(np.asarray(t), axis=1)))
    assert sp(t_hot) > sp(t_init)


def test_w_prior_nll_adds_exactly_the_coverage_term_and_trains_heads():
    """w_prior_nll (config.py): best-of-prior-lanes NLL. With identical
    params/key the flag-on total must exceed the flag-off total by exactly
    w * prior_nll (pure additive term), and it must deliver gradient to both
    the conditional-prior head and the z_temp_learn temperature head (the
    variety min-NLL almost never selects prior lanes, so without this term
    those heads starve)."""
    mk = dict(z_temp_learn=True, prior_lane_frac=0.5)
    cfg_on = tiny_cfg(w_prior_nll=0.5, **mk)
    cfg_off = tiny_cfg(w_prior_nll=0.0, **mk)  # explicit: 0.5 is the default
    params = desire.init_desire(jax.random.PRNGKey(0), cfg_on)
    xy = jax.random.uniform(jax.random.PRNGKey(2),
                            (cfg_on.batch_size, cfg_on.total_len,
                             cfg_on.max_num_obj, 2)) * 0.5 + 0.2
    mask = jnp.ones(xy.shape[:3])
    ids = jnp.arange(1, cfg_on.max_num_obj + 1,
                     dtype=jnp.float32)[None].repeat(cfg_on.batch_size, 0)
    key = jax.random.PRNGKey(3)
    (t_on, m_on), grads = jax.value_and_grad(
        lambda p: desire.desire_loss(p, cfg_on, xy, mask, ids, key=key,
                                     step=0), has_aux=True)(params)
    t_off, m_off = desire.desire_loss(params, cfg_off, xy, mask, ids,
                                      key=key, step=0)
    assert "prior_nll" in m_on and "prior_nll" not in m_off
    np.testing.assert_allclose(float(t_on - t_off),
                               0.5 * float(m_on["prior_nll"]), rtol=1e-4)
    for head in ("prior", "ztemp_fc2"):
        g = np.asarray(grads["sgm"][head]["w"])
        assert np.isfinite(g).all() and np.abs(g).max() > 0, head


def test_vae_mlp_geometry_for_nonstandard_rnn_size():
    """rnn_size != 512 (any 2*rnn_size perfect square) must work end to end —
    the conv-VAE arithmetic only closes at vae side 32, so other sizes take
    the MLP VAE path (round-1 weak item: the CLI accepted sizes the model
    then hard-failed on)."""
    for rnn_size in (128, 32):           # sides 16 and 8
        cfg = tiny_cfg(rnn_size=rnn_size)
        p = sgm.init_sgm(jax.random.PRNGKey(0), cfg)
        assert "venc1" not in p and "venc_fc1" in p
        n = 4
        obs = jnp.full((n, cfg.obs_len, 2), 0.5)
        fut = jnp.full((n, cfg.pred_len, 2), 0.55)
        out = sgm.sgm_forward(p, cfg, obs, jnp.ones((n, cfg.obs_len)),
                              fut, jnp.ones((n, cfg.pred_len)),
                              key=jax.random.PRNGKey(1), train=True)
        assert out["raw5"].shape == (n, cfg.num_samples, cfg.pred_len, 5)
        assert np.isfinite(np.asarray(out["raw5"])).all()
    # full model incl. IOC + loss + grad on the MLP path
    cfg = tiny_cfg(rnn_size=128)
    params = desire.init_desire(jax.random.PRNGKey(0), cfg)
    xy = jax.random.uniform(jax.random.PRNGKey(2),
                            (cfg.batch_size, cfg.total_len,
                             cfg.max_num_obj, 2)) * 0.5 + 0.2
    mask = jnp.ones(xy.shape[:3])
    ids = jnp.arange(1, cfg.max_num_obj + 1,
                     dtype=jnp.float32)[None].repeat(cfg.batch_size, 0)
    (loss, _), grads = jax.value_and_grad(
        lambda p: desire.desire_loss(p, cfg, xy, mask, ids,
                                     key=jax.random.PRNGKey(3), step=0),
        has_aux=True)(params)
    assert np.isfinite(float(loss))
    assert all(np.isfinite(np.asarray(g)).all()
               for g in jax.tree_util.tree_leaves(grads))


def test_remat_is_exact():
    """cfg.remat (jax.checkpoint on the IOC iterations + VAE decode) must
    change memory residency only — loss and grads bit-comparable."""
    xy = jax.random.uniform(jax.random.PRNGKey(2), (2, 7, 4, 2)) * 0.5 + 0.2
    mask = jnp.ones(xy.shape[:3])
    ids = jnp.arange(1, 5, dtype=jnp.float32)[None].repeat(2, 0)
    outs = []
    for remat in (False, True):
        cfg = tiny_cfg(remat=remat)
        params = desire.init_desire(jax.random.PRNGKey(0), cfg)
        (loss, _), grads = jax.value_and_grad(
            lambda p: desire.desire_loss(p, cfg, xy, mask, ids,
                                         key=jax.random.PRNGKey(3), step=0),
            has_aux=True)(params)
        outs.append((float(loss), grads))
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=1e-6)
    # recompute-vs-stash reassociates float reductions -> ~1e-5 noise
    for a, b in zip(jax.tree_util.tree_leaves(outs[0][1]),
                    jax.tree_util.tree_leaves(outs[1][1])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=5e-5)


def test_ranking_ce_cannot_move_hypotheses():
    """The ranking CE may only train the scorer, never the trajectories:
    its gradient w.r.t. the SGM hypotheses must be exactly zero. Round-2
    regression: CE leaked through scores -> pooled features -> refined
    positions and dragged hypotheses ~26 px off their SGM oracle the moment
    the CE target became sharp enough to train."""
    from desire.models import ioc as ioc_mod

    cfg = tiny_cfg()
    params = desire.init_desire(jax.random.PRNGKey(0), cfg)
    b, a, k, tf, d = 2, cfg.max_num_obj, cfg.num_samples, cfg.pred_len, cfg.d_dim
    keys = jax.random.split(jax.random.PRNGKey(1), 4)
    traj = jax.random.uniform(keys[0], (b, a, k, tf, 2)) * 0.5 + 0.2
    dec_h = jax.random.normal(keys[1], (b, a, k, tf, d)) * 0.1
    feat_map = jax.random.normal(keys[2], (b, cfg.scene_grid, cfg.scene_grid,
                                           cfg.scene_channels)) * 0.1
    gt = jax.random.uniform(keys[3], (b, a, tf, 2)) * 0.5 + 0.2
    live = jnp.ones((b, a))
    fut_mask = jnp.ones((b, a, tf))

    def ce_only(traj):
        refined, scores, _ = ioc_mod.ioc_forward(
            params["ioc"], params["scf"], cfg, traj, dec_h, feat_map,
            live, fut_mask)
        return losses.ioc_cross_entropy(scores, refined, gt, live,
                                        step_mask=fut_mask, temperature=0.5)

    g = jax.grad(ce_only)(traj)
    np.testing.assert_allclose(np.asarray(g), 0.0, atol=1e-9)


def test_speed_norm_adaptive_bound():
    """speed_norm scales the residual headroom with each agent's observed
    speed: a fast agent's hypotheses can deviate much further from the CV
    extrapolation than a near-stationary agent's (round-2 bike-scene fix)."""
    cfg = tiny_cfg(speed_norm=True, vel_gain=2.0, vel_floor=0.004)
    p = sgm.init_sgm(jax.random.PRNGKey(0), cfg)
    # saturate the head so the composed bound is visible in the output
    p = dict(p, head={"w": p["head"]["w"],
                      "b": p["head"]["b"] + jnp.array([50., 50., 0., 0., 0.])})
    n, to = 2, cfg.obs_len
    t = jnp.arange(to, dtype=jnp.float32)
    slow = jnp.stack([0.5 + 1e-4 * t, jnp.full((to,), 0.5)], -1)
    fast = jnp.stack([0.1 + 0.05 * t, jnp.full((to,), 0.5)], -1)
    obs = jnp.stack([slow, fast])                        # (2, To, 2)
    out = sgm.sgm_forward(p, cfg, obs, jnp.ones((n, to)),
                          key=jax.random.PRNGKey(1), train=False)
    # per-step deviation from CV extrapolation at step 1 == tanh(50)*bound
    cv = sgm.mean_observed_velocity(obs - obs[:, -1:], jnp.ones((n, to)))
    dev = out["traj_mu"][:, 0, 0, :] - (obs[:, -1] + cv)  # (2, 2)
    bound_slow = cfg.vel_gain * 1e-4 + cfg.vel_floor
    bound_fast = cfg.vel_gain * 0.05 + cfg.vel_floor
    np.testing.assert_allclose(float(dev[0, 0]), bound_slow, rtol=1e-3)
    np.testing.assert_allclose(float(dev[1, 0]), bound_fast, rtol=1e-3)
    # end-to-end: the full model trains finite with speed_norm on
    full = tiny_cfg(speed_norm=True)
    params = desire.init_desire(jax.random.PRNGKey(0), full)
    xy = jax.random.uniform(jax.random.PRNGKey(2),
                            (full.batch_size, full.total_len,
                             full.max_num_obj, 2)) * 0.5 + 0.2
    mask = jnp.ones(xy.shape[:3])
    ids = jnp.arange(1, full.max_num_obj + 1,
                     dtype=jnp.float32)[None].repeat(full.batch_size, 0)
    loss, metrics = desire.desire_loss(params, full, xy, mask, ids,
                                       key=jax.random.PRNGKey(3), step=0)
    assert np.isfinite(float(loss))


def test_sgm_translation_invariance():
    """Shifting the whole trajectory must shift predictions identically
    (origin-relative design)."""
    cfg = tiny_cfg()
    p = sgm.init_sgm(jax.random.PRNGKey(0), cfg)
    n = 3
    obs = jax.random.uniform(jax.random.PRNGKey(1), (n, cfg.obs_len, 2)) * 0.2
    m = jnp.ones((n, cfg.obs_len))
    k = jax.random.PRNGKey(2)
    t1 = sgm.sgm_forward(p, cfg, obs, m, key=k, train=False)["traj_mu"]
    t2 = sgm.sgm_forward(p, cfg, obs + 0.3, m, key=k, train=False)["traj_mu"]
    np.testing.assert_allclose(np.asarray(t2 - t1),
                               np.full(np.shape(t1), 0.3), rtol=1e-3, atol=1e-5)


# -- SCF ----------------------------------------------------------------------

def test_bilinear_pool_exact_on_grid_points():
    b, g, c = 2, 8, 3
    fm = jax.random.normal(jax.random.PRNGKey(0), (b, g, g, c))
    # position exactly at grid cell (ix, iy) -> feature[iy, ix]
    pos = jnp.array([[[3 / (g - 1), 5 / (g - 1)]], [[0.0, 0.0]]])
    out = scf.bilinear_pool(fm, pos)
    np.testing.assert_allclose(np.asarray(out[0, 0]), np.asarray(fm[0, 5, 3]),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(out[1, 0]), np.asarray(fm[1, 0, 0]),
                               rtol=1e-5)


def test_bilinear_pool_interpolates_midpoint():
    fm = jnp.zeros((1, 4, 4, 1)).at[0, 0, 0, 0].set(1.0).at[0, 0, 1, 0].set(3.0)
    # midpoint between x=0 and x=1 at y=0 -> (1+3)/2
    pos = jnp.array([[[0.5 / 3, 0.0]]])
    out = scf.bilinear_pool(fm, pos)
    np.testing.assert_allclose(float(out[0, 0, 0]), 2.0, rtol=1e-5)


def test_social_pool_ignores_dead_and_self():
    cfg = tiny_cfg()
    p = scf.init_scf(jax.random.PRNGKey(0), cfg)
    b, a, k, tf, d = 1, 3, 2, 2, cfg.d_dim
    traj = jnp.zeros((b, a, k, tf, 2))
    dec_h = jax.random.normal(jax.random.PRNGKey(1), (b, a, k, tf, d))
    live = jnp.array([[1.0, 1.0, 0.0]])
    msg = scf.social_messages(p, dec_h)
    out = scf.social_pool(p, traj, msg, live)
    # agent 0's pool = message(agent 1) only (2 dead, self excluded)
    np.testing.assert_allclose(np.asarray(out[:, 0]), np.asarray(msg[:, 1]),
                               rtol=1e-4, atol=1e-5)
    # a lone agent pools zeros
    live_alone = jnp.array([[1.0, 0.0, 0.0]])
    out2 = scf.social_pool(p, traj, msg, live_alone)
    np.testing.assert_allclose(np.asarray(out2[:, 0]), 0.0, atol=1e-6)


# -- full model ---------------------------------------------------------------

def _toy_batch(cfg, key=0):
    b, a, t = cfg.batch_size, cfg.max_num_obj, cfg.total_len
    kx, ki = jax.random.split(jax.random.PRNGKey(key))
    xy = jax.random.uniform(kx, (b, t, a, 2)) * 0.5 + 0.25
    mask = jnp.ones((b, t, a))
    ids = jnp.arange(1, a + 1)[None].repeat(b, 0).astype(jnp.float32)
    # kill last agent everywhere
    ids = ids.at[:, -1].set(0.0)
    mask = mask.at[:, :, -1].set(0.0)
    return xy, mask, ids


def test_desire_forward_and_loss():
    cfg = tiny_cfg()
    params = desire.init_desire(jax.random.PRNGKey(0), cfg)
    xy, mask, ids = _toy_batch(cfg)
    out = jax.jit(lambda p, x, m, i: desire.desire_forward(
        p, cfg, x, m, i, key=jax.random.PRNGKey(1)))(params, xy, mask, ids)
    b, a, K, tf = cfg.batch_size, cfg.max_num_obj, cfg.num_samples, cfg.pred_len
    assert out["refined_traj"].shape == (b, a, K, tf, 2)
    assert out["scores"].shape == (b, a, K)
    assert len(out["per_iter_trajs"]) == cfg.num_refine
    loss, metrics = jax.jit(lambda p, x, m, i: desire.desire_loss(
        p, cfg, x, m, i, key=jax.random.PRNGKey(1), step=100))(
        params, xy, mask, ids)
    assert np.isfinite(float(loss))
    for k in ("nll", "kld", "ioc_ce", "refine_reg"):
        assert np.isfinite(float(metrics[k])), k
    assert float(metrics["kld"]) >= 0


def test_desire_loss_gradients_flow_everywhere():
    cfg = tiny_cfg()
    params = desire.init_desire(jax.random.PRNGKey(0), cfg)
    xy, mask, ids = _toy_batch(cfg)

    def f(p):
        return desire.desire_loss(p, cfg, xy, mask, ids,
                                  key=jax.random.PRNGKey(1), step=100)[0]
    grads = jax.jit(jax.grad(f))(params)
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    norms = {jax.tree_util.keystr(p): float(jnp.linalg.norm(g))
             for p, g in flat}
    assert all(np.isfinite(n) for n in norms.values())
    # Every module must receive gradient (no dead branches) — EXCEPT three
    # leaves that are structurally zero at step 0:
    #   ioc.gate.{w,b}: the delta head is zero-init (near-zero head init,
    #     ioc.py init), so the gate's product-rule factor tanh(delta_head)
    #     is identically 0 until the delta head takes its first update;
    #   ioc.score.b: a bias shared across all K lanes cancels exactly in
    #     the ranking softmax-CE (any nonzero value seen historically was
    #     bf16 roundoff, which made a count-based threshold flaky).
    #   sgm.ztemp_fc1.{w,b}: the temperature head's OUTPUT layer (ztemp_fc2)
    #     is zero-init (temp exactly 1 at init, config.py z_temp_learn), so
    #     the chain rule through it zeroes fc1's gradient until fc2's first
    #     update — same product-rule structure as the ioc gate.
    allowed_zero = {"['ioc']['gate']['w']", "['ioc']['gate']['b']",
                    "['ioc']['score']['b']",
                    "['sgm']['ztemp_fc1']['w']", "['sgm']['ztemp_fc1']['b']"}
    zero = {k for k, n in norms.items() if n == 0.0}
    assert zero <= allowed_zero, f"unexpected zero-grad leaves: {sorted(zero - allowed_zero)}"


def test_dead_agents_do_not_affect_loss():
    """Changing a dead agent's coordinates must not change the loss."""
    cfg = tiny_cfg(use_social=False)  # social pooling sees only live agents anyway
    params = desire.init_desire(jax.random.PRNGKey(0), cfg)
    xy, mask, ids = _toy_batch(cfg)
    l1 = float(desire.desire_loss(params, cfg, xy, mask, ids,
                                  key=jax.random.PRNGKey(1), step=0)[0])
    xy2 = xy.at[:, :, -1, :].set(0.77)  # move the dead agent
    l2 = float(desire.desire_loss(params, cfg, xy2, mask, ids,
                                  key=jax.random.PRNGKey(1), step=0)[0])
    np.testing.assert_allclose(l1, l2, rtol=1e-5)


def test_sgm_only_config():
    cfg = tiny_cfg(use_ioc=False, use_scf=False)
    params = desire.init_desire(jax.random.PRNGKey(0), cfg)
    assert "ioc" not in params
    xy, mask, ids = _toy_batch(cfg)
    loss, metrics = desire.desire_loss(params, cfg, xy, mask, ids,
                                       key=jax.random.PRNGKey(1), step=0)
    assert np.isfinite(float(loss))
    assert "ioc_ce" not in metrics


def test_scene_imagery_channels():
    """scene_image_channels (VERDICT r3 item 8 — the paper-fidelity scene-CNN
    path scf.py promises): imagery channels are consumed by the scene CNN
    (different images -> different feature maps and forward outputs), and a
    missing image falls back to zeros instead of a shape error."""
    cfg = tiny_cfg(scene_image_channels=2)
    params = desire.init_desire(jax.random.PRNGKey(0), cfg)
    # break the IOC delta head's zero-init (refinement is an identity at a
    # fresh init, which would hide the imagery's effect on refined_traj)
    params["ioc"]["delta"]["w"] = 0.3 * jax.random.normal(
        jax.random.PRNGKey(7), (cfg.d_dim, 2))
    # conv1 consumes occupancy(2) + imagery(Ci)
    assert params["scf"]["conv1"]["w"].shape[2] == 4
    g = cfg.scene_grid
    b = cfg.batch_size
    img1 = jax.random.uniform(jax.random.PRNGKey(1), (b, g, g, 2))
    img2 = jax.random.uniform(jax.random.PRNGKey(8), (b, g, g, 2)) * 2.0
    xy, mask, ids = _toy_batch(cfg)
    obs_xy = xy[:, :cfg.obs_len]
    obs_mask = mask[:, :cfg.obs_len]
    f1 = scf.scene_feature_map(params["scf"], obs_xy, obs_mask, g, image=img1)
    f2 = scf.scene_feature_map(params["scf"], obs_xy, obs_mask, g, image=img2)
    assert f1.shape == (b, g, g, cfg.scene_channels)
    assert float(jnp.max(jnp.abs(f1 - f2))) > 1e-6

    out1 = desire.desire_forward(params, cfg, xy, mask, ids,
                                 key=jax.random.PRNGKey(2), train=False,
                                 scene_image=img1)
    out2 = desire.desire_forward(params, cfg, xy, mask, ids,
                                 key=jax.random.PRNGKey(2), train=False,
                                 scene_image=img2)
    d = jnp.max(jnp.abs(out1["refined_traj"] - out2["refined_traj"]))
    assert float(d) > 0.0                   # imagery reaches the refinement
    # no image -> zero raster channels, same shapes, finite outputs
    out0 = desire.desire_forward(params, cfg, xy, mask, ids,
                                 key=jax.random.PRNGKey(2), train=False)
    assert np.isfinite(np.asarray(out0["refined_traj"],
                                  dtype=np.float32)).all()
    # a mismatched grid is rejected, not silently resampled
    with pytest.raises(AssertionError):
        scf.scene_feature_map(params["scf"], obs_xy, obs_mask, g,
                              image=img1[:, : g // 2])


def test_bfloat16_compute_path():
    cfg = tiny_cfg(compute_dtype="bfloat16")
    params = desire.init_desire(jax.random.PRNGKey(0), cfg)
    xy, mask, ids = _toy_batch(cfg)
    loss, _ = jax.jit(
        lambda p, x, m, i: desire.desire_loss(p, cfg, x, m, i,
                                              key=jax.random.PRNGKey(1), step=0)
    )(params, xy, mask, ids)
    assert np.isfinite(float(loss))
    assert loss.dtype == jnp.float32  # loss accumulates in fp32


def test_dropout_active_only_in_training():
    """keep_prob wired (the reference declared it unused): train-time
    forwards with different keys differ even with z fixed via the same key
    split... here we check eval determinism + train stochasticity."""
    cfg = tiny_cfg(keep_prob=0.5, use_ioc=False, use_scf=False)
    p = desire.init_desire(jax.random.PRNGKey(0), cfg)
    xy, mask, ids = _toy_batch(cfg)
    f_eval = jax.jit(lambda k: desire.desire_forward(
        p, cfg, xy, mask, ids, key=k, train=False)["sgm_traj"])
    # eval path: same key -> identical (no dropout)
    np.testing.assert_array_equal(np.asarray(f_eval(jax.random.PRNGKey(3))),
                                  np.asarray(f_eval(jax.random.PRNGKey(3))))
    # train path consumes dropout randomness: loss differs across keys more
    # than it would from z alone with keep_prob=1
    def loss(kp, key):
        c = cfg.replace(keep_prob=kp)
        return float(desire.desire_loss(p, c, xy, mask, ids,
                                        key=key, step=0)[0])
    l_a = loss(0.5, jax.random.PRNGKey(4))
    l_b = loss(0.5, jax.random.PRNGKey(5))
    assert l_a != l_b  # stochastic under dropout


def test_cond_prior_starts_at_standard_normal():
    """The zero-init conditional prior IS N(0, I) at init: inference output
    with cond_prior on equals the unconditional model's bit-for-bit (same
    PRNG stream), and training calibrates it away from zero."""
    key = jax.random.PRNGKey(0)
    cfg_on = tiny_cfg(cond_prior=True, use_ioc=False, use_scf=False)
    cfg_off = tiny_cfg(cond_prior=False, use_ioc=False, use_scf=False)
    p_on = desire.init_desire(key, cfg_on)
    p_off = desire.init_desire(key, cfg_off)
    xy, mask, ids = _toy_batch(cfg_on)
    kf = jax.random.PRNGKey(7)
    out_on = desire.desire_forward(p_on, cfg_on, xy, mask, ids, key=kf,
                                   train=False)
    out_off = desire.desire_forward(p_off, cfg_off, xy, mask, ids, key=kf,
                                    train=False)
    np.testing.assert_array_equal(np.asarray(out_on["refined_traj"]),
                                  np.asarray(out_off["refined_traj"]))
    # zp head reports exactly the standard prior at init
    np.testing.assert_array_equal(np.asarray(out_on["zp_mu"]), 0.0)
    np.testing.assert_array_equal(np.asarray(out_on["zp_logvar"]), 0.0)
    # and the prior head receives gradient through the KLD
    def kl_loss(p):
        o = desire.desire_forward(p, cfg_on, xy, mask, ids, key=kf,
                                  train=True)
        return losses.masked_mean(losses.kld_gaussians(
            o["z_mu"], o["z_logvar"], o["zp_mu"], o["zp_logvar"]), o["live"])
    g = jax.grad(kl_loss)(p_on)
    assert float(jnp.abs(g["sgm"]["prior"]["w"]).sum()) > 0


def test_variety_subset_bounds_full_min():
    """min over a random lane subset >= min over all lanes, every term —
    with identical PRNG streams the variety_k loss dominates the full one."""
    cfg_all = tiny_cfg(num_samples=6, variety_k=0)
    cfg_sub = tiny_cfg(num_samples=6, variety_k=2)
    params = desire.init_desire(jax.random.PRNGKey(0), cfg_all)
    xy, mask, ids = _toy_batch(cfg_all)
    kf = jax.random.PRNGKey(3)
    l_all, _ = desire.desire_loss(params, cfg_all, xy, mask, ids, key=kf,
                                  step=1000)
    l_sub, _ = desire.desire_loss(params, cfg_sub, xy, mask, ids, key=kf,
                                  step=1000)
    assert float(l_sub) >= float(l_all) - 1e-5


def test_aniso_bound_heading_frame():
    """config.py aniso_bound: residuals decode in the observed-heading frame
    with separate along/cross envelopes. With the head zeroed except a
    saturated ALONG channel, the step-1 deviation from CV extrapolation must
    point exactly along the heading with magnitude = the along bound —
    for an agent moving in +y, that means zero x-deviation."""
    cfg = tiny_cfg(speed_norm=True, learn_bound=True, aniso_bound=True,
                   vel_gain=2.0, vel_floor=0.004)
    p = sgm.init_sgm(jax.random.PRNGKey(0), cfg)
    assert "vel_gain_cross_log" in p
    p = dict(p, head={"w": jnp.zeros_like(p["head"]["w"]),
                      "b": jnp.array([50., 0., 0., 0., 0.])})
    to = cfg.obs_len
    t = jnp.arange(to, dtype=jnp.float32)
    # one agent moving +y at 0.05/step, one moving +x at 0.02/step
    up = jnp.stack([jnp.full((to,), 0.5), 0.1 + 0.05 * t], -1)
    right = jnp.stack([0.1 + 0.02 * t, jnp.full((to,), 0.5)], -1)
    obs = jnp.stack([up, right])                          # (2, To, 2)
    n = 2
    out = sgm.sgm_forward(p, cfg, obs, jnp.ones((n, to)),
                          key=jax.random.PRNGKey(1), train=False)
    cv = sgm.mean_observed_velocity(obs - obs[:, -1:], jnp.ones((n, to)))
    dev = out["traj_mu"][:, 0, 0, :] - (obs[:, -1] + cv)  # (2, 2)
    b_up = cfg.vel_gain * 0.05 + cfg.vel_floor
    b_right = cfg.vel_gain * 0.02 + cfg.vel_floor
    np.testing.assert_allclose(float(dev[0, 1]), b_up, rtol=1e-3)
    np.testing.assert_allclose(float(dev[0, 0]), 0.0, atol=1e-6)
    np.testing.assert_allclose(float(dev[1, 0]), b_right, rtol=1e-3)
    np.testing.assert_allclose(float(dev[1, 1]), 0.0, atol=1e-6)

    # end-to-end: trains finite and the CROSS gain receives gradient
    full = tiny_cfg(speed_norm=True, learn_bound=True, aniso_bound=True)
    params = desire.init_desire(jax.random.PRNGKey(0), full)
    xy, mask, ids = _toy_batch(full)
    loss, g = jax.value_and_grad(lambda q: desire.desire_loss(
        q, full, xy, mask, ids, key=jax.random.PRNGKey(1), step=1000)[0]
    )(params)
    assert np.isfinite(float(loss))
    gc = float(g["sgm"]["vel_gain_cross_log"])
    assert np.isfinite(gc) and abs(gc) > 0


def test_learned_bound_receives_gradient():
    cfg = tiny_cfg(speed_norm=True, learn_bound=True, use_ioc=False,
                   use_scf=False)
    params = desire.init_desire(jax.random.PRNGKey(0), cfg)
    assert "vel_gain_log" in params["sgm"]
    xy, mask, ids = _toy_batch(cfg)
    g = jax.grad(lambda p: desire.desire_loss(
        p, cfg, xy, mask, ids, key=jax.random.PRNGKey(1), step=1000)[0]
    )(params)
    assert np.isfinite(float(g["sgm"]["vel_gain_log"]))
    assert abs(float(g["sgm"]["vel_gain_log"])) > 0


def test_z_temp_per_agent_spread_and_isolation():
    """The eval-time z-temperature knob: temp=1 everywhere is a no-op
    (bit-identical to z_temp=None); raising ONE agent's temp increases that
    agent's cross-lane spread while every other agent's output is untouched
    (the noise scaling is strictly per-row)."""
    cfg = tiny_cfg(num_samples=6)
    params = desire.init_desire(jax.random.PRNGKey(0), cfg)
    xy, mask, ids = _toy_batch(cfg)
    key = jax.random.PRNGKey(7)

    base = desire.desire_forward(params, cfg, xy, mask, ids, key=key,
                                 train=False)
    ones = desire.desire_forward(params, cfg, xy, mask, ids, key=key,
                                 train=False,
                                 z_temp=jnp.ones(ids.shape))
    np.testing.assert_array_equal(np.asarray(base["sgm_traj"]),
                                  np.asarray(ones["sgm_traj"]))

    temp = jnp.ones(ids.shape).at[:, 1].set(4.0)
    hot = desire.desire_forward(params, cfg, xy, mask, ids, key=key,
                                train=False, z_temp=temp)

    def lane_spread(out, agent):
        tr = np.asarray(out["sgm_traj"])[:, agent]        # (B, K, T, 2)
        return float(np.mean(np.var(tr, axis=1)))

    # untouched agents: exactly equal
    for agent in (0, 2):
        np.testing.assert_array_equal(
            np.asarray(hot["sgm_traj"])[:, agent],
            np.asarray(base["sgm_traj"])[:, agent])
    # heated agent: strictly more cross-lane variance
    assert lane_spread(hot, 1) > 1.5 * lane_spread(base, 1)
