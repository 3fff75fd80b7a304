"""IOC rank-and-refine (models/ioc.ioc_forward): what refinement moves and
what it must leave alone, social context, the pass count, remat, lane
symmetry and the gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from desire.config import DesireConfig
from desire.models import ioc, scf


def _cfg(**kw):
    base = dict(d_dim=8, scene_channels=3, scene_grid=6, num_refine=3,
                compute_dtype="float32")
    base.update(kw)
    return DesireConfig(**base)


def _setup(cfg, b=2, a=4, k=3, tf=5, seed=0, live=None):
    ks = jax.random.split(jax.random.PRNGKey(seed), 8)
    p_ioc = ioc.init_ioc(ks[0], cfg)
    # non-zero delta/gate heads: the zero init makes refinement the identity
    p_ioc["delta"]["w"] = jax.random.normal(ks[1], p_ioc["delta"]["w"].shape)
    p_ioc["gate"]["w"] = jax.random.normal(ks[2], p_ioc["gate"]["w"].shape)
    p_scf = scf.init_scf(ks[3], cfg)
    traj = jax.random.uniform(ks[4], (b, a, k, tf, 2), minval=0.2, maxval=0.8)
    dec_h = jax.random.normal(ks[5], (b, a, k, tf, cfg.d_dim))
    feat = jax.random.normal(ks[6], (b, cfg.scene_grid, cfg.scene_grid,
                                     cfg.scene_channels))
    live = jnp.ones((b, a)) if live is None else live
    fut_mask = jnp.ones((b, a, tf)).at[:, :, -2:].set(0.0)
    return p_ioc, p_scf, traj, dec_h, feat, live, fut_mask


def _run(cfg, args, **kw):
    with jax.default_matmul_precision("highest"):
        return ioc.ioc_forward(args[0], args[1], cfg, *args[2:], **kw)


def test_refinement_moves_live_steps_and_leaves_masked_steps():
    cfg = _cfg()
    args = _setup(cfg)
    traj, fut_mask = args[2], args[6]
    refined, scores, per_iter = _run(cfg, args)
    moved = np.abs(np.asarray(refined - traj)).sum(-1)       # (B,A,K,Tf)
    m = np.asarray(fut_mask)[:, :, None, :].repeat(traj.shape[2], 2)
    assert np.all(moved[m == 1] > 0)
    np.testing.assert_array_equal(moved[m == 0], 0.0)
    assert scores.shape == traj.shape[:3]
    for t in per_iter:
        np.testing.assert_array_equal(
            np.asarray(t)[m == 0], np.asarray(traj)[m == 0])


def test_single_live_agent_gets_zero_social_context():
    live = jnp.zeros((2, 4)).at[:, 1].set(1.0)
    with_social = _run(_cfg(), _setup(_cfg(), live=live))
    without = _run(_cfg(use_social=False), _setup(_cfg(), live=live))
    # the lone agent's social block is zero, exactly as with social off
    for got, want in zip(with_social[:2], without[:2]):
        np.testing.assert_allclose(np.asarray(got[:, 1]),
                                   np.asarray(want[:, 1]), atol=1e-6)


def test_social_freeze_pools_at_the_initial_positions():
    cfg = _cfg(social_freeze=True)
    p_ioc, p_scf, traj, dec_h, feat, live, fut_mask = _setup(cfg)
    refined, scores, per_iter = _run(cfg, _setup(cfg))
    with jax.default_matmul_precision("highest"):
        msg = scf.social_messages(p_scf, dec_h)
        social0 = scf.social_pool(p_scf, traj, msg, live)
        t = traj
        for want in per_iter:
            feats = scf.fuse_context(p_scf, cfg, t, msg, feat, live,
                                     social=social0)
            _, deltas, _ = ioc.score_and_delta(p_ioc, feats, dec_h, fut_mask,
                                               cfg.scene_channels)
            t = t + deltas
            np.testing.assert_allclose(np.asarray(t), np.asarray(want),
                                       atol=1e-6)
        feats = scf.fuse_context(p_scf, cfg, t, msg, feat, live,
                                 social=social0)
        s, _, _ = ioc.score_and_delta(p_ioc, feats, dec_h, fut_mask,
                                      cfg.scene_channels)
    np.testing.assert_allclose(np.asarray(scores), np.asarray(s), atol=1e-5)


@pytest.mark.parametrize("num_refine", [0, 1, 4])
def test_num_refine_sets_the_pass_count(num_refine):
    cfg = _cfg(num_refine=num_refine)
    args = _setup(cfg)
    refined, _, per_iter = _run(cfg, args)
    assert len(per_iter) == max(num_refine, 1)          # 0 clamps to 1
    np.testing.assert_array_equal(np.asarray(refined),
                                  np.asarray(per_iter[-1]))
    if num_refine == 0:
        one, _, _ = _run(_cfg(num_refine=1), args)
        np.testing.assert_array_equal(np.asarray(refined), np.asarray(one))
    for prev, cur in zip(per_iter, per_iter[1:]):
        assert float(jnp.max(jnp.abs(cur - prev))) > 0   # every pass moves


def test_remat_changes_neither_values_nor_gradients():
    args = _setup(_cfg())

    def loss(p_ioc, p_scf, traj, cfg):
        r, s, per = ioc.ioc_forward(p_ioc, p_scf, cfg, traj, *args[3:])
        return jnp.sum(r ** 2) + jnp.sum(s) + sum(jnp.sum(t) for t in per)

    out = {}
    for remat in (False, True):
        cfg = _cfg(remat=remat)
        with jax.default_matmul_precision("highest"):
            out[remat] = jax.value_and_grad(loss, argnums=(0, 1, 2))(
                args[0], args[1], args[2], cfg)
    np.testing.assert_allclose(float(out[False][0]), float(out[True][0]),
                               rtol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(out[False][1]),
                    jax.tree_util.tree_leaves(out[True][1])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)


def test_lane_permutation_equivariance():
    cfg = _cfg()
    p_ioc, p_scf, traj, dec_h, feat, live, fut_mask = _setup(cfg, k=5)
    perm = np.array([3, 0, 4, 1, 2])
    r, s, _ = _run(cfg, (p_ioc, p_scf, traj, dec_h, feat, live, fut_mask))
    rp, sp, _ = _run(cfg, (p_ioc, p_scf, traj[:, :, perm], dec_h[:, :, perm],
                           feat, live, fut_mask))
    np.testing.assert_allclose(np.asarray(rp), np.asarray(r[:, :, perm]),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(sp), np.asarray(s[:, :, perm]),
                               atol=1e-5)


def test_gradient_matches_finite_differences():
    """Directional derivative of a refinement loss along a random
    direction in the IOC and SCF parameters, against central differences.
    (The scores are left out: the final scoring pass stop-gradients the
    refined positions by design, so their finite difference differs.)"""
    cfg = _cfg(num_refine=2)
    p_ioc, p_scf, traj, dec_h, feat, live, fut_mask = _setup(cfg)
    params = {"ioc": p_ioc, "scf": p_scf}
    w = jax.random.normal(jax.random.PRNGKey(11), traj.shape)

    def loss(p):
        r, _, _ = ioc.ioc_forward(p["ioc"], p["scf"], cfg, traj, dec_h,
                                  feat, live, fut_mask)
        return jnp.sum(r * w)

    leaves, tree = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(12), len(leaves))
    v = jax.tree_util.tree_unflatten(
        tree, [jax.random.normal(k_, x.shape) for k_, x in zip(keys, leaves)])
    with jax.default_matmul_precision("highest"):
        g = jax.grad(loss)(params)
        analytic = sum(float(jnp.sum(a * b)) for a, b in zip(
            jax.tree_util.tree_leaves(g), jax.tree_util.tree_leaves(v)))
        eps = 1e-3
        shift = lambda s: jax.tree_util.tree_map(  # noqa: E731
            lambda p, d: p + s * d, params, v)
        numeric = (float(loss(shift(eps))) - float(loss(shift(-eps)))) \
            / (2 * eps)
    np.testing.assert_allclose(analytic, numeric, rtol=2e-2, atol=1e-3)
