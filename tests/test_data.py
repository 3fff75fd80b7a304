"""Data pipeline: preprocessing parity, windowing/slotting/masking semantics,
determinism + resume (SURVEY.md §4 unit tier)."""

import os

import numpy as np
import pytest

from desire.config import DesireConfig
from desire.data import loader as loader_mod
from desire.data import preprocess, windows


def _write_micro_csv(path, records):
    """records: list of (frame, id, x, y) -> transposed 4-row csv
    (layout of reference scripts/preprocess.py:31-34)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    arr = np.asarray(records, dtype=np.float64).T
    with open(path, "w") as f:
        for row in arr:
            f.write(",".join(f"{v:g}" for v in row) + "\n")


@pytest.fixture
def micro_tree(tmp_path):
    """Two 'scenes', deterministic synthetic trajectories at native rate."""
    recs_a, recs_b = [], []
    for f in range(40):
        recs_a.append((f, 1, 10.0 + f, 20.0 + 2 * f))     # agent 1: all frames
        if f >= 5:
            recs_a.append((f, 2, 100.0 - f, 50.0))         # agent 2: frames 5+
        if f % 2 == 0:
            recs_a.append((f, 3, 5.0, 5.0 + f))            # agent 3: even frames
        if f < 3:
            recs_a.append((f, 4, 60.0, 60.0 + f))          # agent 4: frames 0-2
    for f in range(25):
        recs_b.append((f, 7, 1.0 + f, 1.0))
    _write_micro_csv(str(tmp_path / "sceneA/video0/annotations_processed.csv"), recs_a)
    _write_micro_csv(str(tmp_path / "sceneB/video0/annotations_processed.csv"), recs_b)
    return str(tmp_path)


def test_preprocess_txt_roundtrip(tmp_path):
    # annotations.txt -> csv, bbox center math per reference preprocess.py:25-26
    txt = tmp_path / "annotations.txt"
    txt.write_text('5 10 20 30 40 100 x y z "l"\n6 0 0 10 10 101 a b c "m"\n')
    csv = preprocess.convert_annotation_file(str(txt))
    rec = preprocess.read_processed_csv(csv)
    np.testing.assert_array_equal(rec[0], [100, 101])   # frames
    np.testing.assert_array_equal(rec[1], [5, 6])       # ids
    np.testing.assert_array_equal(rec[2], [20.0, 5.0])  # (xmin+xmax)/2
    np.testing.assert_array_equal(rec[3], [30.0, 5.0])  # (ymin+ymax)/2


def test_video_index_subsample_and_normalize():
    frames = np.arange(24)
    ids = np.ones(24)
    xy = np.stack([np.arange(24.0), np.arange(24.0) * 2], -1)
    v = windows.build_video_index("v", frames, ids, xy, subsample=12,
                                  normalize=True)
    assert v.num_steps == 2            # frames 0 and 12 survive
    assert v.scale == 46.0             # max coordinate (y at frame 23=46)
    np.testing.assert_allclose(v.rec_xy[:, 0] * v.scale, [0.0, 12.0])


def test_window_full_obs_eligibility(micro_tree):
    cfg = DesireConfig(protocol="paper", obs_len=4, pred_len=3, subsample=2,
                       max_num_obj=5, window_hop=1, batch_size=2,
                       data_dir=micro_tree)
    ld = loader_mod.SDDLoader(cfg, use_native=False)
    # sceneA at subsample=2: agents 1 (all), 3 (even frames -> all sampled
    # steps), 2 (frames>=5 -> sampled steps 3+).
    b = ld.materialize()
    a_batch = b.xy[b.video == 0]
    a_ids = b.ids[b.video == 0]
    # first window of sceneA starts at step 0: agent 2 misses obs -> excluded
    w0 = a_ids[0]
    assert set(w0[w0 > 0].tolist()) == {1, 3}
    # a later window (start>=3) includes agent 2
    late = a_ids[-1]
    assert 2 in set(late[late > 0].tolist())


def test_window_mask_and_positions(micro_tree):
    cfg = DesireConfig(protocol="paper", obs_len=3, pred_len=2, subsample=1,
                       max_num_obj=4, window_hop=100, batch_size=1,
                       data_dir=micro_tree, scenes="sceneA")
    ld = loader_mod.SDDLoader(cfg, use_native=False)
    b = ld.materialize(1)
    # window = frames 0..4 of sceneA. Eligibility needs presence at ALL 3 obs
    # steps: agent 1 (always) and agent 4 (frames 0-2) qualify; agent 3 (even
    # frames, misses step 1) and agent 2 (starts frame 5) do not.
    ids = b.ids[0]
    slot1 = int(np.where(ids == 1)[0][0])
    slot4 = int(np.where(ids == 4)[0][0])
    assert 2 not in ids and 3 not in ids
    np.testing.assert_array_equal(b.mask[0, :, slot1], [1, 1, 1, 1, 1])
    # agent 4 has full obs but no future -> future steps masked out
    np.testing.assert_array_equal(b.mask[0, :, slot4], [1, 1, 1, 0, 0])
    # positions de-normalize to the synthetic ground truth
    got = b.xy[0, :, slot1] * b.scale[0]
    want = np.stack([10.0 + np.arange(5), 20.0 + 2 * np.arange(5)], -1)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_compat_protocol_one_frame_shift(micro_tree):
    ld = loader_mod.CompatDataLoader(batch_size=2, seq_length=8,
                                     max_num_obj=6, leave_dataset=5,
                                     data_dir=micro_tree)
    x, y, d = ld.next_batch()
    assert len(x) == 2 and x[0].shape == (8, 6, 3)
    # target == source shifted by one step wherever the same agent persists
    # (reference utils/data_loader.py:206-210)
    np.testing.assert_allclose(x[0][1:], y[0][:-1], atol=1e-6)
    # id column is column 0 (train.py feed layout)
    live = x[0][0, :, 0] > 0
    assert live.any()


def test_determinism_and_resume(micro_tree):
    cfg = DesireConfig(protocol="paper", obs_len=3, pred_len=2, subsample=1,
                       max_num_obj=4, window_hop=1, batch_size=4,
                       data_dir=micro_tree, seed=7)
    ld1 = loader_mod.SDDLoader(cfg, use_native=False)
    ld2 = loader_mod.SDDLoader(cfg, use_native=False)
    e1 = list(ld1.epoch_batches(epoch=3))
    e2 = list(ld2.epoch_batches(epoch=3))
    assert len(e1) == ld1.num_batches > 1
    for a, b in zip(e1, e2):
        np.testing.assert_array_equal(a.xy, b.xy)
    # epochs differ (shuffling works)
    other = next(iter(ld2.epoch_batches(epoch=4)))
    assert not np.array_equal(e1[0].xy, other.xy)
    # resume mid-epoch reproduces the tail exactly
    it = ld1.epoch_batches(epoch=5)
    next(it)
    state = ld1.state
    tail_live = list(it)
    tail_resumed = list(ld2.resume_iter(state))
    assert len(tail_live) == len(tail_resumed)
    for a, b in zip(tail_live, tail_resumed):
        np.testing.assert_array_equal(a.xy, b.xy)


def test_video_index_cache_roundtrip(micro_tree, tmp_path, monkeypatch):
    """The npz VideoIndex cache (VERDICT r4 item 10): the second loader
    start must serve identical indices from cache without re-reading the
    CSVs, and a touched CSV must invalidate its entry (the reference's
    trajectories.cpkl went stale silently — utils/data_loader.py:52-64)."""
    from desire.data import loader as L
    monkeypatch.setenv("DESIRE_CACHE_DIR", str(tmp_path / "cache"))
    cfg = DesireConfig(protocol="paper", obs_len=2, pred_len=1, subsample=2,
                       batch_size=2, max_num_obj=4, window_hop=1,
                       holdout="none", data_dir=micro_tree)
    l1 = L.SDDLoader(cfg)
    entries = list((tmp_path / "cache").glob("vi_*.npz"))
    assert len(entries) == 2  # one per video

    calls = {"n": 0}
    real = L._native_or_python_reader(True)

    def counting(path):
        calls["n"] += 1
        return real(path)

    monkeypatch.setattr(L, "_native_or_python_reader", lambda use: counting)
    l2 = L.SDDLoader(cfg)
    assert calls["n"] == 0  # served entirely from cache
    assert l2.num_windows == l1.num_windows
    for a, b in zip(l1.videos, l2.videos):
        assert a.name == b.name and a.scale == b.scale
        np.testing.assert_array_equal(a.frame_ptr, b.frame_ptr)
        np.testing.assert_array_equal(a.rec_xy, b.rec_xy)
        np.testing.assert_array_equal(a.rec_ids, b.rec_ids)

    # touching a CSV re-parses it (content-identity key)
    p = os.path.join(micro_tree, "sceneA/video0/annotations_processed.csv")
    os.utime(p, ns=(os.stat(p).st_atime_ns, os.stat(p).st_mtime_ns + 7))
    L.SDDLoader(cfg)
    assert calls["n"] == 1

    # kill switch
    monkeypatch.setenv("DESIRE_DATA_CACHE", "0")
    L.SDDLoader(cfg)
    assert calls["n"] == 3


def test_occupancy_prior_and_scene_raster_batches(micro_tree):
    """VERDICT r4 item 7 plumbing: the per-video occupancy prior puts its
    mass where the records are, normalizes to [0,1], and the loader attaches
    the right video's raster to every batch window."""
    cfg = DesireConfig(protocol="paper", obs_len=2, pred_len=1, subsample=2,
                       batch_size=2, max_num_obj=4, window_hop=1,
                       holdout="none", data_dir=micro_tree,
                       scene_image_channels=1, scene_grid=8)
    loader = loader_mod.SDDLoader(cfg, use_native=False)
    assert loader.scene_rasters is not None
    assert loader.scene_rasters.shape == (len(loader.videos), 8, 8, 1)
    for vi, v in enumerate(loader.videos):
        r = loader.scene_rasters[vi]
        assert 0.0 <= r.min() and abs(r.max() - 1.0) < 1e-6
        # mass sits where the records are: the weighted centroid of the
        # raster must be close to the records' mean position
        g = r[..., 0]
        ys, xs = np.mgrid[0:8, 0:8]
        cx = float((g * xs).sum() / g.sum()) / 7.0
        cy = float((g * ys).sum() / g.sum()) / 7.0
        mx, my = v.rec_xy.mean(axis=0)
        assert abs(cx - mx) < 0.25 and abs(cy - my) < 0.25, (v.name, cx, mx)
    b = next(loader.epoch_batches(0))
    assert b.image is not None and b.image.shape == (2, 8, 8, 1)
    for i in range(b.batch_size):
        np.testing.assert_array_equal(b.image[i],
                                      loader.scene_rasters[b.video[i]])


def test_scene_raster_image_dir_source(micro_tree, tmp_path):
    """scene_image_source=<dir>: per-video reference rasters read from
    files, resampled onto the isotropic [0,1]^2 annotation frame."""
    cfg0 = DesireConfig(protocol="paper", obs_len=2, pred_len=1, subsample=2,
                        batch_size=2, max_num_obj=4, window_hop=1,
                        holdout="none", data_dir=micro_tree)
    base = loader_mod.SDDLoader(cfg0, use_native=False)
    imgroot = tmp_path / "imgs"
    for v in base.videos:
        d = imgroot / v.name
        d.mkdir(parents=True)
        side = int(np.ceil(v.scale))
        img = np.linspace(0, 1, side * side, dtype=np.float32
                          ).reshape(side, side)
        np.save(d / "reference.npy", img)
    cfg = cfg0.replace(scene_image_channels=1,
                       scene_image_source=str(imgroot), scene_grid=8)
    loader = loader_mod.SDDLoader(cfg, use_native=False)
    r = loader.scene_rasters
    assert r.shape == (len(base.videos), 8, 8, 1)
    # the gradient image must survive resampling: monotone along y
    col = r[0, :, 0, 0]
    assert np.all(np.diff(col) >= 0) and col[-1] > col[0]


def test_scene_filter_and_missing_dir(micro_tree, tmp_path):
    cfg = DesireConfig(protocol="paper", obs_len=3, pred_len=2, subsample=1,
                       max_num_obj=4, window_hop=1, batch_size=2,
                       data_dir=micro_tree, scenes="sceneB")
    ld = loader_mod.SDDLoader(cfg, use_native=False)
    assert all(v.name.startswith("sceneB") for v in ld.videos)
    with pytest.raises(FileNotFoundError):
        loader_mod.SDDLoader(cfg, data_dir=str(tmp_path / "empty"),
                             use_native=False)


def test_native_parser_matches_python_if_built(micro_tree):
    from desire.data.native import fast_csv
    if not fast_csv.available():
        pytest.skip("libfast_csv.so not built")
    path = os.path.join(micro_tree, "sceneA/video0/annotations_processed.csv")
    nf = fast_csv.read_processed_csv(path)
    pf = loader_mod._python_reader(path)
    for a, b in zip(nf, pf):
        np.testing.assert_allclose(a, b, rtol=1e-6)


@pytest.fixture
def split_tree(tmp_path):
    """3 scenes: sceneA has 3 videos, sceneB has 2, sceneC has 1 (stays
    fully in train — holding out its only video would delete the scene)."""
    def traj(seed, n=30):
        rng = np.random.default_rng(seed)
        return [(f, 1, 10.0 + f + rng.normal(), 20.0 + f) for f in range(n)]
    layout = {"sceneA": ["video0", "video1", "video2"],
              "sceneB": ["video10", "video9"],   # lexicographic: video9 last
              "sceneC": ["video0"]}
    i = 0
    for scene, vids in layout.items():
        for v in vids:
            _write_micro_csv(
                str(tmp_path / scene / v / "annotations_processed.csv"),
                traj(i))
            i += 1
    return str(tmp_path)


def test_holdout_partition(split_tree):
    """holdout='video': train/heldout are a disjoint deterministic partition;
    the last-sorted video of every >=2-video scene is held out."""
    held = loader_mod.heldout_videos(
        ["sceneA/video0", "sceneA/video1", "sceneA/video2",
         "sceneB/video10", "sceneB/video9", "sceneC/video0"])
    assert held == {"sceneA/video2", "sceneB/video9"}

    cfg = DesireConfig(protocol="paper", obs_len=3, pred_len=2, subsample=1,
                       max_num_obj=4, window_hop=1, batch_size=2,
                       data_dir=split_tree)
    names = lambda ld: {v.name for v in ld.videos}
    all_ld = loader_mod.SDDLoader(cfg, use_native=False)
    tr = loader_mod.SDDLoader(cfg, use_native=False, split="train")
    ho = loader_mod.SDDLoader(cfg, use_native=False, split="heldout")
    assert names(tr) | names(ho) == names(all_ld)
    assert not (names(tr) & names(ho))
    assert names(ho) == {"sceneA/video2", "sceneB/video9"}
    assert "sceneC/video0" in names(tr)          # 1-video scene stays in train
    # deterministic across constructions
    assert names(loader_mod.SDDLoader(cfg, use_native=False,
                                      split="heldout")) == names(ho)


def test_holdout_none_rejects_split(split_tree):
    cfg = DesireConfig(protocol="paper", obs_len=3, pred_len=2, subsample=1,
                       max_num_obj=4, window_hop=1, batch_size=2,
                       data_dir=split_tree, holdout="none")
    with pytest.raises(ValueError):
        loader_mod.SDDLoader(cfg, use_native=False, split="train")
