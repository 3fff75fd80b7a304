"""Reference-surface compatibility: the facade accepts the reference's args
namespace and tensor layouts (SURVEY §7.1 item 8)."""

import argparse

import numpy as np
import pytest

from desire import compat


def _reference_args(**kw):
    """The reference's 19 flags with its defaults (train.py:30-88), except
    tiny dims for test speed."""
    ns = argparse.Namespace(
        rnn_size=512, num_layers=1, model="gru", batch_size=2, seq_length=6,
        num_epochs=1, save_every=400, grad_clip=10.0, learning_rate=1e-3,
        decay_rate=0.95, keep_prob=0.8, embedding_size=8,
        neighborhood_size=32, grid_size=4, max_num_obj=5, leave_dataset=5,
        latent_size=8, e_dim=256, d_dim=16, stride=1)
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


def _traj(rng, t, a):
    """(T, A, 3) reference layout: col0 = id (0 = empty slot)."""
    out = np.zeros((t, a, 3), np.float32)
    for i in range(a - 1):  # leave last slot empty
        v = rng.uniform(-1, 1, 2)
        p0 = rng.uniform(10, 50, 2)
        out[:, i, 0] = i + 1
        out[:, i, 1:3] = p0 + np.arange(t)[:, None] * v
    return out


@pytest.fixture(scope="module")
def model():
    # scene/social extras scaled down for CPU test speed
    m = compat.DESIREModel(_reference_args())
    m.cfg = m.cfg.replace(scene_grid=8, scene_channels=4, num_refine=1,
                          channel_multiplier=10, num_samples=2,
                          compute_dtype="float32")
    # rebuild with the small config
    m = compat.DESIREModel(_reference_args())
    return m


def test_constructor_accepts_reference_args():
    m = compat.DESIREModel(_reference_args())
    assert m.cfg.protocol == "compat"
    assert m.cfg.seq_length == 6
    assert m.cfg.max_num_obj == 5


def test_train_step_reference_layout(model):
    rng = np.random.RandomState(0)
    full = _traj(rng, 7, 5)
    x, y = full[:6], full[1:7]
    l1 = model.train_step(x, y)
    l2 = model.train_step(x, y)
    assert np.isfinite(l1) and np.isfinite(l2)


def test_sample_reference_signature(model):
    rng = np.random.RandomState(1)
    traj = _traj(rng, 6, 5)
    out = model.sample(None, traj, grid=None, dimensions=(100, 100), num=4)
    assert out.shape == (10, 5, 3)
    # observed part passed through untouched
    np.testing.assert_array_equal(out[:6], traj)
    # ids carried forward; empty slot stays empty
    np.testing.assert_array_equal(
        out[6:, :, 0], np.broadcast_to(traj[0, :, 0], (4, 5)))
    assert np.isfinite(out).all()
    # predictions continue from the last observed position (continuity)
    live = traj[0, :, 0] > 0
    jump = np.linalg.norm(out[6, live, 1:3] - traj[-1, live, 1:3], axis=-1)
    spread = np.linalg.norm(traj[-1, live, 1:3] - traj[0, live, 1:3], axis=-1)
    assert (jump < np.maximum(spread, 5.0) * 3).all()


def test_sample_late_appearing_agent(model):
    """Regression (VERDICT r1 weak #7): an agent absent at the window's
    first frame must still get an id slot and predictions — ids are keyed
    from any occupied frame, not frame 0 (the reference keyed per-frame)."""
    rng = np.random.RandomState(3)
    traj = _traj(rng, 6, 5)
    late = 3                      # make slot `late` appear only from frame 2
    traj[:2, late, :] = 0.0
    traj[2:, late, 0] = late + 1
    out = model.sample(None, traj, num=4)
    # the late agent keeps its id in the predicted frames...
    np.testing.assert_array_equal(out[6:, late, 0], np.full(4, late + 1))
    # ...and gets real (nonzero, finite, continuous) predictions
    assert np.isfinite(out[6:, late, 1:3]).all()
    assert np.abs(out[6:, late, 1:3]).sum() > 0
    jump = np.linalg.norm(out[6, late, 1:3] - traj[-1, late, 1:3])
    assert jump < 50.0


def test_sample_arbitrary_obs_length(model):
    """The reference sample() accepts any obs_length; under the compat
    protocol the split used to be pinned to seq_length (mis-split)."""
    rng = np.random.RandomState(2)
    traj = _traj(rng, 4, 5)    # obs length 4 != seq_length 6
    out = model.sample(None, traj, num=3)
    assert out.shape == (7, 5, 3)
    np.testing.assert_array_equal(out[:4], traj)
    assert np.isfinite(out).all()
