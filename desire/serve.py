"""Production inference serving: forecast futures from observations only.

``evaluate.py`` consumes complete windows (observed past + ground-truth
future) because it scores metrics; a deployed forecaster has no futures.
This module is that serving surface: a :class:`Predictor` restores a
checkpoint once, compiles ONE fixed-shape program, and turns trailing
observation histories into K IOC-ranked future trajectories, plus a
rolling-buffer stream server for frame-by-frame feeds.

Reference counterpart: ``DESIREModel.sample``
(/root/reference/model/model.py:613-688) — a per-step ``sess.run`` loop
over one agent set that redraws the graph state every frame (and is broken
as checked in, SURVEY §8). Here the whole batch of windows — all agents,
all K lanes, SGM draw + IOC rank/refine — is one jitted dispatch on fixed
shapes, so a long-lived server never recompiles and its steady-state
latency is the device step time.

Semantics note (unknown futures): the model's future mask normally comes
from ground-truth presence (models/desire.split_batch). At serving time the
future is unknown, so the mask is set to 1 for every live agent across the
full horizon — the IOC refinement and scores then cover all ``pred_len``
steps. This matches what evaluate.py measures (windows where the agent is
present throughout).
"""

from __future__ import annotations

import collections
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from desire.config import DesireConfig
from desire.eval import metrics as M
from desire.models import desire
from desire.models.desire import init_desire
from desire.train import checkpoint as ckpt_mod
from desire.train.state import create_train_state


class Predictor:
    """Checkpoint-backed, fixed-shape, jit-once forecaster.

    Parameters
    ----------
    save_dir : checkpoint directory (train.py --save_dir). Geometry fields
        are taken from the saved config (ckpt_mod.GEOMETRY_FIELDS) — the
        caller cannot accidentally evaluate with mismatched shapes.
    k_samples : hypotheses per agent (default: the checkpoint's num_samples).
    max_windows : compiled batch capacity; predict() pads up to it. Pick the
        largest concurrent window count the deployment expects.
    best : restore save_dir/best instead of the latest checkpoint.
    params/cfg : bypass checkpoint loading (tests, embedding in another
        process that already holds the state).
    mesh : optional (data, k) jax.sharding.Mesh for scale-out serving —
        windows shard over the ``data`` axis and hypothesis lanes over
        ``k`` (the model's in-graph shard hints), exactly the inference
        layout trainer.make_eval_forward uses. Requires
        max_windows % mesh_data == 0.
    """

    def __init__(self, save_dir: str | None = None, *, k_samples=None,
                 max_windows: int = 8, best: bool = False, seed: int = 0,
                 params=None, cfg: DesireConfig | None = None, mesh=None,
                 scene_image=None):
        """scene_image: optional (G, G, Ci) scene raster for checkpoints
        trained with cfg.scene_image_channels > 0 (a server handles one
        camera/scene, so the raster is a constant, broadcast per window).
        predict.py derives it from the CSV's aggregate occupancy; omitted,
        a zero raster is used (the model sees occupancy-only context)."""
        if params is None or cfg is None:
            if not save_dir:
                raise ValueError("need save_dir or explicit (params, cfg)")
            saved = None
            if best:
                # best/ carries its own config incl. the fitted rank blend
                saved = ckpt_mod.load_config(os.path.join(save_dir, "best"))
            if saved is None:
                saved = ckpt_mod.load_config(save_dir)
            if saved is None:
                raise FileNotFoundError(f"no config.json in {save_dir}")
            cfg = ckpt_mod.overlay_geometry(cfg or DesireConfig(), saved)
            params = init_desire(jax.random.PRNGKey(cfg.seed), cfg)
            state = create_train_state(cfg, params, steps_per_epoch=100)
            ckpt_dir = f"{save_dir}/best" if best else save_dir
            got = ckpt_mod.CheckpointManager(ckpt_dir).restore(state)
            if got is None:
                raise FileNotFoundError(f"no checkpoint found in {ckpt_dir}")
            params = got[0].params
        self.cfg = cfg
        self.params = params
        self.k = int(k_samples or cfg.num_samples)
        self.max_windows = int(max_windows)
        self.obs_len = cfg.obs_len if cfg.protocol == "paper" \
            else cfg.seq_length
        self.pred_len = cfg.total_len - self.obs_len
        self._key = jax.random.PRNGKey(seed)
        self._calls = 0
        self._latencies_ms: list[float] = []

        self._default_img = None
        if cfg.scene_image_channels > 0:
            g, ci = cfg.scene_grid, cfg.scene_image_channels
            base = (np.zeros((g, g, ci), np.float32) if scene_image is None
                    else np.asarray(scene_image, np.float32))
            assert base.shape == (g, g, ci), (base.shape, (g, g, ci))
            # a traced argument (not a baked constant): predict_windows can
            # override it per call (predict.py forecasts several CSVs with
            # one compiled program)
            self._default_img = np.broadcast_to(
                base, (self.max_windows, g, g, ci)).copy()

        def fn(params, xy, mask, ids, key, img=None):
            out = desire.desire_forward(params, cfg, xy, mask, ids,
                                        key=key, k_samples=self.k,
                                        train=False, scene_image=img)
            traj = out["refined_traj"]                     # (B, A, K, Tf, 2)
            scores = out["scores"]
            if scores is None:
                scores = jnp.zeros(traj.shape[:3], traj.dtype)
            # top-1 ranks with the train-split-fitted blend when the
            # checkpoint carries one (config rank_blend_fit)
            return traj, scores, M.best_of_k_by_score(
                traj, scores, blend=max(cfg.rank_blend_fit, 0.0))

        if mesh is None:
            self._fn = jax.jit(fn)
        else:
            from desire.parallel import mesh as mesh_mod
            data_size = mesh.shape[mesh_mod.DATA_AXIS]
            if self.max_windows % data_size:
                raise ValueError(
                    f"max_windows={self.max_windows} must divide over the "
                    f"data axis ({data_size} devices)")
            bsh = mesh_mod.batch_sharding(mesh)
            rep = mesh_mod.replicated(mesh)
            in_sh = (rep, bsh, bsh, bsh, rep)
            if self._default_img is not None:
                in_sh += (bsh,)
            self._fn = mesh_mod.under_mesh(
                mesh, jax.jit(fn, in_shardings=in_sh))

    # -- shape assembly ------------------------------------------------------

    def _assemble(self, windows):
        """windows: list of (obs_xy (A*,To,2) normalized, obs_mask (A*,To),
        ids (A*,)) with A* <= max_num_obj — pad to the compiled shapes."""
        b, a = self.max_windows, self.cfg.max_num_obj
        t = self.cfg.total_len
        to = self.obs_len
        xy = np.zeros((b, t, a, 2), np.float32)
        mask = np.zeros((b, t, a), np.float32)
        ids = np.zeros((b, a), np.int64)
        for i, (oxy, omask, wids) in enumerate(windows):
            oxy = np.asarray(oxy, np.float32)
            omask = np.asarray(omask, np.float32)
            wids = np.asarray(wids, np.int64)
            na, nt = oxy.shape[0], oxy.shape[1]
            if nt != to:
                raise ValueError(f"window {i}: expected obs_len={to} steps, "
                                 f"got {nt}")
            na = min(na, a)
            xy[i, :to, :na] = np.swapaxes(oxy[:na], 0, 1)
            mask[i, :to, :na] = np.swapaxes(omask[:na], 0, 1)
            ids[i, :na] = wids[:na]
            # unknown future: refine/score the whole horizon for every agent
            # that is live at the last observed step (see module docstring)
            live = (wids[:na] != 0) & (omask[:na, -1] > 0)
            mask[i, to:, :na] = live[None, :].astype(np.float32)
            ids[i, :na] *= live.astype(np.int64)
        return xy, mask, ids

    # -- public API ----------------------------------------------------------

    def predict_windows(self, windows, scales=None, key=None,
                        scene_image=None):
        """Forecast a list of windows (each: obs_xy (A,To,2) in raw pixels,
        obs_mask (A,To), ids (A,)). scales: per-window pixels-per-unit
        normalization (the per-video isotropic scale the model was trained
        with — windows.build_video_index); scalar or list; default 1.0
        (inputs already normalized). scene_image: optional (G, G, Ci)
        raster overriding the constructor's (scene_image_channels > 0
        checkpoints only).

        Returns a list of dicts per window: ids (A,), traj (A,K,Tf,2) raw
        pixels, scores (A,K), best (A,Tf,2) raw pixels, live (A,) bool.
        """
        if len(windows) > self.max_windows:
            out = []
            for i in range(0, len(windows), self.max_windows):
                sc = scales[i:i + self.max_windows] \
                    if isinstance(scales, (list, tuple, np.ndarray)) else scales
                out.extend(self.predict_windows(
                    windows[i:i + self.max_windows], sc, key, scene_image))
            return out
        scales = np.broadcast_to(
            np.asarray(scales if scales is not None else 1.0, np.float32),
            (len(windows),))
        normed = [(np.asarray(oxy, np.float32) / scales[i], om, wids)
                  for i, (oxy, om, wids) in enumerate(windows)]
        xy, mask, ids = self._assemble(normed)
        if key is None:
            self._key, key = jax.random.split(self._key)
        extra = ()
        if self._default_img is not None:
            si = self._default_img if scene_image is None else \
                np.broadcast_to(np.asarray(scene_image, np.float32),
                                self._default_img.shape)
            extra = (jnp.asarray(si),)
        t0 = time.perf_counter()
        traj, scores, best = self._fn(self.params, xy, mask, ids, key,
                                      *extra)
        traj, scores, best = (np.asarray(traj), np.asarray(scores),
                              np.asarray(best))
        self._latencies_ms.append((time.perf_counter() - t0) * 1e3)
        self._calls += 1
        out = []
        for i in range(len(windows)):
            # agents beyond capacity were truncated by _assemble
            na = min(np.asarray(windows[i][2]).shape[0], self.cfg.max_num_obj)
            s = scales[i]
            out.append({
                "ids": ids[i, :na].copy(),
                "live": ids[i, :na] != 0,
                "traj": traj[i, :na] * s,
                "scores": scores[i, :na],
                "best": best[i, :na] * s,
            })
        return out

    def predict(self, obs_xy, obs_mask, ids, scale=1.0, key=None,
                scene_image=None):
        """Single-window convenience wrapper of predict_windows."""
        return self.predict_windows([(obs_xy, obs_mask, ids)],
                                    [scale], key, scene_image)[0]

    def warmup(self):
        """Trigger compilation before serving traffic (one dummy window)."""
        a = self.cfg.max_num_obj
        self.predict(np.zeros((a, self.obs_len, 2), np.float32),
                     np.zeros((a, self.obs_len), np.float32),
                     np.zeros((a,), np.int64))
        self._latencies_ms.pop()          # don't count compile in stats
        self._calls -= 1
        return self

    def stats(self):
        lat = np.asarray(self._latencies_ms, np.float64)
        if not len(lat):
            return {"calls": 0}
        return {"calls": self._calls,
                "latency_ms_p50": round(float(np.percentile(lat, 50)), 2),
                "latency_ms_p95": round(float(np.percentile(lat, 95)), 2),
                "latency_ms_mean": round(float(lat.mean()), 2),
                "windows_per_sec": round(
                    1e3 * self._calls / float(lat.sum()), 2)}


class StreamServer:
    """Rolling-buffer frame feed -> forecasts, for live serving.

    Input protocol (one JSON object per line):
        {"frame": 1234, "agents": [[id, x, y], ...]}
    Coordinates are raw pixels; ``scale`` is the per-scene normalization
    (pixels-per-unit) the checkpoint was trained with. Frames off the
    ``subsample`` grid (cfg.subsample, anchored at the first frame seen)
    update nothing — same timeline the training windows used.

    Once ``obs_len`` sampled steps have accumulated, every aligned frame
    yields one forecast dict (Predictor.predict output + frame/step).
    """

    def __init__(self, predictor: Predictor, scale: float):
        self.p = predictor
        self.scale = float(scale)
        cfg = predictor.cfg
        self.subsample = cfg.subsample if cfg.protocol == "paper" else 1
        self.obs_len = predictor.obs_len
        self.f0: int | None = None
        # per-agent history of (step, x, y), newest last
        self.hist: dict[int, collections.deque] = {}
        self.step = -1

    def observe(self, frame: int, agents):
        """Feed one frame. Returns a forecast dict when one is due, else
        None. agents: iterable of (id, x, y)."""
        if self.f0 is None:
            self.f0 = int(frame)
        if (int(frame) - self.f0) % self.subsample:
            return None
        step = (int(frame) - self.f0) // self.subsample
        self.step = step
        for aid, x, y in agents:
            aid = int(aid)
            if aid == 0:          # id 0 is the empty-slot sentinel
                continue
            self.hist.setdefault(
                aid, collections.deque(maxlen=self.obs_len)).append(
                (step, float(x), float(y)))
        # drop agents not seen for a full window
        gone = [aid for aid, h in self.hist.items()
                if step - h[-1][0] >= self.obs_len]
        for aid in gone:
            del self.hist[aid]
        if step + 1 < self.obs_len:
            return None
        return self._forecast(step)

    def _forecast(self, step: int):
        to = self.obs_len
        a_max = self.p.cfg.max_num_obj
        # agents present NOW, deterministic slot order (sorted by id —
        # windows.materialize_window semantics), truncated to max_num_obj
        now = sorted(aid for aid, h in self.hist.items()
                     if h[-1][0] == step)[:a_max]
        if not now:
            return None
        na = len(now)
        oxy = np.zeros((na, to, 2), np.float32)
        om = np.zeros((na, to), np.float32)
        for i, aid in enumerate(now):
            for s, x, y in self.hist[aid]:
                t = s - (step - to + 1)
                if 0 <= t < to:
                    oxy[i, t] = (x, y)
                    om[i, t] = 1.0
        ids = np.asarray(now, np.int64)
        out = self.p.predict(oxy, om, ids, scale=self.scale)
        out["frame"] = self.f0 + step * self.subsample
        out["step"] = step
        return out


def forecast_to_json(out, top_k: int = 5) -> str:
    """Serialize one forecast dict (Predictor/StreamServer output) to a
    compact JSON line. top_k: hypotheses emitted per agent, by IOC score
    (0 = all)."""
    agents = []
    live = np.asarray(out["live"])
    scores = np.asarray(out["scores"])
    for i in np.flatnonzero(live):
        order = np.argsort(-scores[i])
        if top_k:
            order = order[:top_k]
        agents.append({
            "id": int(out["ids"][i]),
            "top1": np.round(out["best"][i], 2).tolist(),
            "scores": np.round(scores[i][order], 4).tolist(),
            "hypotheses": np.round(out["traj"][i][order], 2).tolist(),
        })
    rec = {k: int(out[k]) for k in ("frame", "step") if k in out}
    rec["agents"] = agents
    return json.dumps(rec)
