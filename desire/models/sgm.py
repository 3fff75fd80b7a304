"""Sample Generation Module (SGM): the CVAE trajectory sampler.

Capability target = reference components C3-C12 (SURVEY §2.1):

* temporal-conv trajectory features rho  -> reference model/model.py:126-133
* past / future GRU encoders             -> model/model.py:136-167,233-241
* fusion FC -> conv-VAE encode -> reparameterized z -> deconv decode
                                          -> model/model.py:243-267,453-492
* softmax mask beta applied to the past encoding ("masking" the encoding
  with the CVAE sample)                   -> model/model.py:271-280
* K-hypothesis GRU decoder + 5-param bivariate-Gaussian head
                                          -> model/model.py:279-289 (K was
                                             hardcoded 7; here a flag)

Redesign decisions (vs the reference's per-agent graph loop,
model/model.py:211):

* agents are a batch dimension — all per-agent compute is one big (N, ...)
  array program, N = batch*agents, masked by agent validity;
* K hypothesis lanes are a second batch dimension inside the decoder —
  (N*K) rows flow through the same matmuls;
* the decoder emits per-step *velocity* Gaussians composed by cumulative sum
  into absolute positions (translation-invariant; the reference predicted raw
  absolute coords and then clamped samples at 1.0 despite never normalizing —
  SURVEY §8);
* GroupNorm replaces prettytensor batchnorm in the VAE stacks (phase-free,
  vmap/shard-safe; documented deviation);
* all randomness is counter-based (jax.random), split per lane — reproducible
  under jit/vmap/sharding.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from desire.config import DesireConfig
from desire.models import layers as L
from desire.parallel.sharding import shard_hint


def init_sgm(key, cfg: DesireConfig, dtype=jnp.float32) -> dict:
    ks = list(jax.random.split(key, 16))
    d = cfg.d_dim
    emb = cfg.embedding_size
    cm = cfg.channel_multiplier
    side = cfg.vae_side
    lat = cfg.latent_size
    in_f = 5 if cfg.input_norm else 4     # +log-speed under input_norm
    p = {
        # input feature embedding: [xy_rel, dxy(, log-speed)] -> emb
        "embed_x": L.init_dense(ks[0], in_f, emb, dtype),
        "embed_y": L.init_dense(ks[1], in_f, emb, dtype),
        "enc_x": L.init_gru_stack(ks[2], emb, d, cfg.num_layers, dtype),
        "enc_y": L.init_gru_stack(ks[3], emb, d, cfg.num_layers, dtype),
        # depthwise temporal conv over the full obs window:
        # weight (To, 2, cm) -> features 2*cm (reference temporal_w
        # (1, seq, 2, 100), model/model.py:425-431)
        "temporal_w": L.glorot(ks[4], (cfg.obs_len, 2, cm), dtype),
        "temporal_b": jnp.zeros((2 * cm,), dtype),
        # recognition fusion: concat(hx, hy) -> vae input "image"
        "fuse": L.init_dense(ks[5], 2 * d, cfg.vae_input_size, dtype),
        # post-VAE mask head (reference w_post_vae, model/model.py:439-443)
        "post_vae": L.init_dense(ks[14], cfg.vae_input_size, d, dtype),
        # direct z -> mask-logits / seed paths. The DESIRE paper computes the
        # softmax mask from z through an fc directly; the reference instead
        # routes z through 4 deconvs + sigmoid first (model/model.py:266-276),
        # which attenuates the latent signal to ~1% of a constant background —
        # measured to collapse all K lanes within an epoch. Both paths kept:
        # mask logits get dense(recon) + dense(z); the seed gets an additive
        # z projection.
        "z_gate": L.init_dense(jax.random.fold_in(key, 98), lat, d, dtype),
        "z_skip": L.init_dense(jax.random.fold_in(key, 97), lat, d, dtype),
        # temporal-conv feature projection into the decoder seed: the
        # reference multiplied decoder outputs into halves of rho as its
        # "feature pooling" stand-in (model/model.py:291-311, an unfinished
        # design per SURVEY §7.4); here rho conditions the decoder directly
        "rho_proj": L.init_dense(jax.random.fold_in(key, 96), 2 * cm, d,
                                 dtype),
        # K-lane GRU decoder + bivariate head. The head starts NEAR zero
        # (glorot x 0.05): its velocity channels are residuals around the
        # constant-velocity extrapolation (compose_positions), so an
        # untrained model predicts ~the CV baseline (full glorot drifted
        # ~1500px, measured; exact zero stalls K-lane symmetry breaking).
        "dec": L.init_gru_stack(ks[15], d, d, cfg.num_layers, dtype),
        "head": L.init_dense(jax.random.fold_in(key, 99), d, 5, dtype,
                             scale=0.05),
    }
    if cfg.cond_prior:
        # conditional prior p(z|X): zero-init -> the prior starts exactly at
        # N(0, I) (the paper's unconditional prior) and training moves it
        # only where KL evidence demands; inference draws from it, so prior
        # samples know the agent's observed dynamics (config.py cond_prior)
        p["prior"] = {"w": jnp.zeros((d, 2 * cfg.latent_size), dtype),
                      "b": jnp.zeros((2 * cfg.latent_size,), dtype)}
    if cfg.speed_norm and cfg.learn_bound:
        # learned residual-envelope scalars (log-domain: positivity), init
        # at the config values; observed speed itself stays stop-gradient
        p["vel_gain_log"] = jnp.asarray(jnp.log(cfg.vel_gain), dtype)
        p["vel_floor_log"] = jnp.asarray(jnp.log(cfg.vel_floor), dtype)
        if cfg.aniso_bound:
            # cross-track gain starts EQUAL to the along-track one (the
            # heading-frame decode is then an exact reparameterization of
            # the isotropic envelope's reachable set); training separates
            # them (config.py aniso_bound)
            p["vel_gain_cross_log"] = jnp.asarray(
                jnp.log(cfg.vel_gain), dtype)
    if cfg.pace_range > 0:
        # per-lane pace head (config.py pace_range): zero-init -> pace
        # factor exactly 1 at init (the pre-flag composition); reads the
        # lane's FIRST decode hidden
        p["pace"] = {"w": jnp.zeros((d, 1), dtype),
                     "b": jnp.zeros((1,), dtype)}
    if cfg.z_temp_learn:
        # learned latent-temperature head (config.py z_temp_learn):
        # log1p(speed/floor) -> 8 -> log-temp, zero-init last layer so
        # temp starts exactly 1.0. Keys are fold_in'd (not drawn from ks)
        # so enabling the flag perturbs no other parameter's init.
        p["ztemp_fc1"] = L.init_dense(jax.random.fold_in(key, 95), 1, 8,
                                      dtype)
        p["ztemp_fc2"] = {"w": jnp.zeros((8, 1), dtype),
                          "b": jnp.zeros((1,), dtype)}
    if side == 32:
        # conv recognition network of the reference (model/model.py:471-492):
        # the fused 1024-vector reshaped to a 32x32 "image" and conv-encoded.
        # Kernel/stride arithmetic only closes for side==32. Runs only at
        # TRAIN time on N agent rows (not N*K lanes) — cheap; kept at
        # reference geometry regardless of the decoder choice below.
        p.update({
            "venc1": L.init_conv(ks[6], 5, 5, 1, 32, dtype),
            "vgn1": L.init_groupnorm(32, dtype),
            "venc2": L.init_conv(ks[7], 5, 5, 32, 64, dtype),
            "vgn2": L.init_groupnorm(64, dtype),
            "venc3": L.init_conv(ks[8], 5, 5, 64, 128, dtype),
            "vgn3": L.init_groupnorm(128, dtype),
            "venc_fc": L.init_dense(ks[9], (side // 8) * (side // 8) * 128,
                                    2 * lat, dtype),
        })
    else:
        # any other rnn_size (the reference CLI accepts them, its model
        # crashes — SURVEY §8): an MLP recognition network of equivalent
        # capability; the "image" is just the fused vector
        hid = max(4 * lat, side * side // 2)
        p.update({
            "venc_fc1": L.init_dense(ks[6], side * side, hid, dtype),
            "venc_fc": L.init_dense(ks[9], hid, 2 * lat, dtype),
        })
    if side == 32 and cfg.vae_dec == "conv":
        # deconv decoder at the reference's exact geometry
        # (model/model.py:453-469). Runs per (agent, lane) — the dominant
        # SGM cost at inference (config.py vae_dec note); default is 'mlp'.
        p.update({
            "vdec1": L.init_conv(ks[10], 4, 4, lat, 128, dtype),
            "vdgn1": L.init_groupnorm(128, dtype),
            "vdec2": L.init_conv(ks[11], 5, 5, 128, 64, dtype),
            "vdgn2": L.init_groupnorm(64, dtype),
            "vdec3": L.init_conv(ks[12], 5, 5, 64, 32, dtype),
            "vdgn3": L.init_groupnorm(32, dtype),
            "vdec4": L.init_conv(ks[13], 5, 5, 32, 1, dtype),
        })
    else:
        hid = max(4 * lat, side * side // 2)
        p.update({
            "vdec_fc1": L.init_dense(ks[10], lat, hid, dtype),
            "vdec_fc": L.init_dense(ks[11], hid, side * side, dtype),
        })
    return p


def temporal_features(p, rel_xy, obs_mask):
    """rho: depthwise full-window temporal conv + ReLU (reference C3).

    rel_xy: (N, To, 2); obs_mask: (N, To). Returns (N, 2*cm).
    Depthwise conv with a VALID full-length window degenerates to a per-
    channel weighted sum over time — expressed as one einsum so XLA maps it
    onto a matmul instead of a conv window loop.
    """
    x = rel_xy * obs_mask[..., None]
    feat = jnp.einsum("ntc,tcm->ncm", x, p["temporal_w"].astype(x.dtype),
                      preferred_element_type=x.dtype)
    feat = feat.reshape(feat.shape[0], -1) + p["temporal_b"].astype(x.dtype)
    return jax.nn.relu(feat)


def _traj_feats(xy_rel, mask, extra=None):
    """Per-step input features: [position, velocity(, extra)], masked.

    extra: optional (N, F) per-agent features broadcast over the window
    (input_norm appends log-speed here so the scale removed from the
    coordinates stays visible to the network)."""
    d = jnp.diff(xy_rel, axis=1, prepend=xy_rel[:, :1])
    fs = [xy_rel, d]
    if extra is not None:
        fs.append(jnp.broadcast_to(extra[:, None],
                                   xy_rel.shape[:2] + extra.shape[-1:]))
    return jnp.concatenate(fs, -1) * mask[..., None]


def encode_trajectory(stack, embed_p, xy_rel, mask, dropout_key=None,
                      keep_prob=1.0, extra=None):
    """GRU-encode a trajectory. xy_rel: (N, T, 2), mask: (N, T).
    Returns top-layer final hidden (N, H).

    keep_prob < 1 with a dropout_key applies inverted dropout to the
    embedded features (train only) — the reference declared this flag but
    never wired it (train.py:62-63, SURVEY §5 config row)."""
    feats = jax.nn.relu(L.dense(embed_p, _traj_feats(xy_rel, mask,
                                                     extra=extra)))
    if dropout_key is not None and keep_prob < 1.0:
        keep = jax.random.bernoulli(dropout_key, keep_prob, feats.shape)
        feats = feats * keep.astype(feats.dtype) / keep_prob
    xs = jnp.swapaxes(feats, 0, 1)                      # (T, N, emb)
    m = jnp.swapaxes(mask, 0, 1)                        # (T, N)
    n, h = xs.shape[1], stack[0]["wh"].shape[0]
    h0 = jnp.zeros((len(stack), n, h), xs.dtype)
    finals, _ = L.gru_stack_scan(stack, h0, xs, mask=m)
    return finals[-1], finals


def vae_encode(p, hx, hy, side):
    """Recognition network q(z | X, Y): fuse encodings -> conv stack (side 32,
    reference geometry) or MLP (any other vae side) -> (mu, logvar).
    hx/hy: (N, d)."""
    fused = jax.nn.relu(L.dense(p["fuse"], jnp.concatenate([hx, hy], -1)))
    if "venc1" in p:
        img = fused.reshape(-1, side, side, 1)
        h = jax.nn.elu(L.groupnorm(p["vgn1"],
                                   L.conv2d(p["venc1"], img, stride=2)))
        h = jax.nn.elu(L.groupnorm(p["vgn2"],
                                   L.conv2d(p["venc2"], h, stride=2)))
        h = jax.nn.elu(L.groupnorm(p["vgn3"],
                                   L.conv2d(p["venc3"], h, padding="VALID")))
        h = h.reshape(h.shape[0], -1)
    else:
        h = jax.nn.elu(L.dense(p["venc_fc1"], fused))
    out = L.dense(p["venc_fc"], h)
    mu, logvar = jnp.split(out, 2, axis=-1)
    return mu, logvar


def vae_decode_mask(p, z, side):
    """Deconv decode z -> 32x32 'reconstruction' -> softmax mask beta
    (reference model/model.py:266-276). z: (M, latent) -> beta (M, d).

    Deviations from the reference masking head (model/model.py:271-276),
    both measured necessary to avoid total K-lane collapse:
    * no relu before the softmax (dead-ReLU trap: an all-negative row makes
      the softmax exactly uniform with zero gradient forever);
    * the mask logits get a direct dense(z) term (the paper's fc-from-z
      masking) on top of dense(recon), and the softmax is rescaled to mean 1
      so the gate modulates rather than shrinks the encoding by 1/d.
    """
    if "vdec1" in p:
        h = z[:, None, None, :]
        h = jax.nn.elu(L.groupnorm(p["vdgn1"],
                                   L.deconv2d(p["vdec1"], h, padding="VALID")))
        h = jax.nn.elu(L.groupnorm(p["vdgn2"],
                                   L.deconv2d(p["vdec2"], h, padding="VALID")))
        h = jax.nn.elu(L.groupnorm(p["vdgn3"],
                                   L.deconv2d(p["vdec3"], h, stride=2)))
        h = jax.nn.sigmoid(L.deconv2d(p["vdec4"], h, stride=2))
        recon = h.reshape(h.shape[0], -1)               # (M, side*side)
    else:
        h = jax.nn.elu(L.dense(p["vdec_fc1"], z))
        recon = jax.nn.sigmoid(L.dense(p["vdec_fc"], h))
    d = p["post_vae"]["w"].shape[-1]
    logits = L.dense(p["post_vae"], recon) + L.dense(p["z_gate"], z)
    beta = jax.nn.softmax(logits, axis=-1) * d
    return beta, recon


def decode_hypotheses(p, cfg: DesireConfig, h_seed, h_init, pred_len):
    """K-lane GRU decoder (reference C12 'rnn_decoder', model/model.py:279-289).

    h_seed: (M, d)  — beta ⊙ hx, fed at every step (reference semantics);
    h_init: (L, M, d) — encoder final states as the initial decoder state.
    Returns raw (M, Tf, 5) head outputs and hidden states (M, Tf, d).
    """
    m, d = h_seed.shape
    if len(p["dec"]) == 1:
        # the seed is constant across steps -> hoist x@Wi out of the scan
        # (saves Tf-1 redundant (M,d)@(d,3d) matmuls; bit-identical result)
        _, hs = L.gru_scan_const_x(p["dec"][0], h_init[0], h_seed, pred_len)
    else:
        xs = jnp.broadcast_to(h_seed, (pred_len, m, d))
        _, hs = L.gru_stack_scan(p["dec"], h_init, xs)   # (Tf, M, d)
    raw = L.dense(p["head"], hs)                         # (Tf, M, 5)
    return jnp.swapaxes(raw, 0, 1), jnp.swapaxes(hs, 0, 1)


def compose_positions(raw, origin, vel_scale=0.25, cv_vel=None,
                      vel_bound=None, vel_bound_cross=None, heading=None):
    """Velocity-residuals-around-constant-velocity -> absolute position
    Gaussians.

    raw: (..., Tf, 5) per-step [dvx, dvy, log_sx, log_sy, rho_raw];
    origin: (..., 2) last observed position; cv_vel: (..., 2) mean observed
    velocity. The mean trajectory is the constant-velocity extrapolation
    plus a cumulative sum of tanh-bounded learned corrections:

        mu_t = origin + cv_vel * t + cumsum(tanh(dv) * bound)

    where bound = vel_scale (fixed, scene units/step), or the per-agent
    `vel_bound` (..., 1) when given (speed_norm: vel_gain*speed + vel_floor —
    the same tanh output then expresses walker- and bike-scale corrections
    with the same head weights).

    Rationale (measured): a constant-velocity baseline scores ADE 33 px on
    SDD @4.8 s — predicting raw velocities forces the network to *relearn*
    linear extrapolation before it can beat that; predicting CV-residuals
    starts the model AT the baseline. The tanh bound doubles as the physical
    prior that keeps out-of-distribution prior-z draws in-scene. Returns raw5
    with absolute means in channels 0:2.
    """
    bound = vel_scale if vel_bound is None else vel_bound[..., None, :]
    if heading is not None:
        # anisotropic heading-frame decode (config.py aniso_bound): raw
        # channels are (along, cross) residuals in the observed-heading
        # frame, each with its own envelope, rotated back to scene xy.
        # heading is a (..., 2) unit vector (stop-gradient, data-derived);
        # at heading=(1,0) this reduces exactly to the isotropic formula
        # with per-channel bounds.
        ca = heading[..., None, 0:1]
        sa = heading[..., None, 1:2]
        va = jnp.tanh(raw[..., 0:1]) * bound
        vc = jnp.tanh(raw[..., 1:2]) * vel_bound_cross[..., None, :]
        vel = jnp.concatenate([va * ca - vc * sa, va * sa + vc * ca],
                              axis=-1)
    else:
        vel = jnp.tanh(raw[..., 0:2]) * bound
    mu = origin[..., None, :] + jnp.cumsum(vel, axis=-2)
    if cv_vel is not None:
        t = jnp.arange(1, raw.shape[-2] + 1, dtype=mu.dtype)
        mu = mu + cv_vel[..., None, :] * t[:, None]
    return jnp.concatenate([mu, raw[..., 2:]], axis=-1)


def _lane_cv(p, cfg, cv_vel, dec_h):
    """Per-lane constant-velocity base (N, K, 2).

    With the pace head (config.py pace_range), each lane scales its CV base
    by 1 + pace_range*tanh(head(first decode hidden)) — explicit along-track
    hypothesis spread (brake/accelerate lanes). Zero-init head -> factor 1.
    """
    cv_k = cv_vel[:, None, :]
    if "pace" in p:
        pace = 1.0 + cfg.pace_range * jnp.tanh(
            L.dense(p["pace"], dec_h[:, :, 0].astype(jnp.float32)))
        if cfg.pace_lanes > 0:
            # subset pace (config.py pace_lanes): only the last n lanes
            # carry the spread; the rest keep the exact vanilla CV base
            k = dec_h.shape[1]
            lane_on = (jnp.arange(k) >= k - cfg.pace_lanes).astype(
                pace.dtype)[None, :, None]
            pace = 1.0 + (pace - 1.0) * lane_on
        cv_k = cv_k * pace                                    # (N, K, 2)
    return cv_k


def observed_speed(rel_obs, obs_mask):
    """Masked mean per-step speed (magnitude) over the observed window.
    rel_obs (N, To, 2), obs_mask (N, To) -> (N, 1). Uses step-speed
    magnitudes, not |mean velocity| — a turning bike keeps its speed."""
    both = obs_mask[:, 1:] * obs_mask[:, :-1]
    d = jnp.linalg.norm(jnp.diff(rel_obs, axis=1), axis=-1) * both
    steps = jnp.maximum(jnp.sum(both, axis=1), 1e-6)
    return (jnp.sum(d, axis=1) / steps)[..., None]


def mean_observed_velocity(rel_obs, obs_mask):
    """Masked mean per-step velocity over the observed window.
    rel_obs (N, To, 2), obs_mask (N, To) -> (N, 2)."""
    both = obs_mask[:, 1:] * obs_mask[:, :-1]
    d = jnp.diff(rel_obs, axis=1) * both[..., None]
    steps = jnp.maximum(jnp.sum(both, axis=1), 1e-6)
    return jnp.sum(d, axis=1) / steps[..., None]


def _residual_envelope(p, cfg, rel_obs, obs_mask, cv_vel):
    """Per-agent residual envelope for compose_positions.

    Returns (vel_bound, vel_bound_cross, heading): the speed-adaptive
    along-track bound (N, 1, 1) (or None when not speed_norm), plus — under
    config.py aniso_bound — a separately-learned cross-track bound and the
    observed-heading unit vector (N, 1, 2) that compose_positions rotates
    the residual frame by. Speed and heading are stop-gradient
    (data-derived); gains/floor are the learned envelope scalars.
    """
    if not cfg.speed_norm:
        return None, None, None
    s = jax.lax.stop_gradient(observed_speed(rel_obs, obs_mask))
    if "vel_gain_log" in p:
        gain = jnp.exp(p["vel_gain_log"]).astype(s.dtype)
        floor = jnp.exp(p["vel_floor_log"]).astype(s.dtype)
    else:
        gain, floor = cfg.vel_gain, cfg.vel_floor
    vel_bound = (gain * s + floor)[:, None]               # (N, 1, 1)
    if "vel_gain_cross_log" not in p:
        return vel_bound, None, None
    gain_c = jnp.exp(p["vel_gain_cross_log"]).astype(s.dtype)
    bound_c = (gain_c * s + floor)[:, None]               # (N, 1, 1)
    nrm = jnp.linalg.norm(cv_vel, axis=-1, keepdims=True)  # (N, 1)
    # near-stationary agents get an arbitrary (but unit) frame — harmless,
    # since both bounds collapse to the shared floor there
    u = jnp.where(nrm > 1e-6, cv_vel / jnp.maximum(nrm, 1e-6),
                  jnp.asarray([1.0, 0.0], cv_vel.dtype))
    return vel_bound, bound_c, jax.lax.stop_gradient(u)[:, None, :]


def _learned_z_temp(p, cfg, rel_obs, obs_mask):
    """Learned speed-conditioned latent temperature (config.py z_temp_learn).

    A tiny MLP on the stop-gradient observed log-speed -> per-agent noise
    temperature in [1/3, 3] (smooth tanh bound in log domain), shape
    (N, 1, 1). Returns None when the head is absent. The head is trained
    only through PRIOR-drawn lanes (sgm_forward), where extra spread is pure
    hypothesis diversity — the posterior lanes and the NLL sigmas never see
    it, so reconstruction and calibration terms cannot absorb it.
    """
    if "ztemp_fc1" not in p:
        return None
    s = jax.lax.stop_gradient(observed_speed(rel_obs, obs_mask))  # (N, 1)
    f = jnp.log1p(s / cfg.vel_floor).astype(jnp.float32)
    lt = L.dense(p["ztemp_fc2"], jnp.tanh(L.dense(p["ztemp_fc1"], f)))
    cap = 1.0986123  # log 3
    return jnp.exp(cap * jnp.tanh(lt / cap))[..., None]          # (N, 1, 1)


def sgm_forward(p, cfg: DesireConfig, obs_xy, obs_mask, fut_xy=None,
                fut_mask=None, *, key, k_samples=None, train=True,
                z_temp=None):
    """Full SGM pass over flattened agent rows.

    obs_xy: (N, To, 2) absolute normalized; fut_xy: (N, Tf, 2) (train only).
    Returns dict with absolute-position Gaussians for K hypotheses.

    z_temp: optional (N, 1, 1) per-agent sampling temperature, applied to
    the latent noise at INFERENCE only (z = mu + sigma * temp * eps) — an
    eval-time spread knob (fast agents' error is along-track speed-profile
    under-coverage; extra latent spread buys hypothesis diversity without
    retraining). Identity at temp=1; ignored in the train branch.
    """
    K = k_samples or cfg.num_samples
    n = obs_xy.shape[0]
    side = cfg.vae_side
    lat = cfg.latent_size
    pred_len = fut_xy.shape[1] if fut_xy is not None else cfg.pred_len
    cd = jnp.bfloat16 if cfg.compute_dtype == "bfloat16" else jnp.float32

    # Positions/geometry stay float32 end-to-end: bf16 has ~2^-9 relative
    # precision, which quantizes [0,1] coords by ~1-4 px at SDD scene scale —
    # enough to bias both the composed trajectory means and (upstream) the
    # NLL targets. Only the network-internal tensors (embeddings, GRU/conv
    # activations) run in compute_dtype.
    obs_xy = obs_xy.astype(jnp.float32)
    obs_mask = obs_mask.astype(jnp.float32)

    # translation invariance: work relative to each agent's last observed point
    origin = obs_xy[:, -1]                                # (N, 2)
    rel_obs = (obs_xy - origin[:, None]) * obs_mask[..., None]

    key, kdx, kdy = jax.random.split(key, 3)
    kp = cfg.keep_prob if train else 1.0

    # scale-free encoding (config.py input_norm): the encoders see the
    # trajectory SHAPE (coords / observed speed) plus an explicit log-speed
    # feature; geometry below (origin, CV composition, NLL targets) stays
    # absolute. Speed is stop-gradient (data-derived, like the bound).
    enc_rel, enc_extra, inv_scale = rel_obs, None, None
    if cfg.input_norm:
        s_obs = jax.lax.stop_gradient(observed_speed(rel_obs, obs_mask))
        inv_scale = 1.0 / (s_obs + cfg.vel_floor)             # (N, 1)
        enc_rel = rel_obs * inv_scale[:, None]
        enc_extra = jnp.log1p(s_obs / cfg.vel_floor).astype(cd)

    rho = temporal_features(p, enc_rel.astype(cd), obs_mask.astype(cd))
    rho_seed = jax.nn.relu(L.dense(p["rho_proj"], rho))          # (N, d)

    # learned latent temperature (config.py z_temp_learn): at inference it
    # composes multiplicatively with the manual --z_temp_fast knob; at train
    # it scales only the prior-lane noise below
    lt = _learned_z_temp(p, cfg, rel_obs, obs_mask)
    if not train and lt is not None:
        z_temp = lt if z_temp is None else z_temp * lt

    hx, hx_all = encode_trajectory(p["enc_x"], p["embed_x"],
                                   enc_rel.astype(cd), obs_mask.astype(cd),
                                   dropout_key=kdx if train else None,
                                   keep_prob=kp, extra=enc_extra)

    # conditional prior p(z|X) (config.py cond_prior): zero-init head ->
    # starts exactly N(0, I). logvar is tanh-bounded (smooth, keeps gradients
    # unlike a hard clip) so prior variances stay in [e^-4, e^4].
    mu_p = logvar_p = None
    if "prior" in p:
        pr = L.dense(p["prior"], hx)
        mu_p, lv_raw = jnp.split(pr, 2, axis=-1)
        logvar_p = 4.0 * jnp.tanh(lv_raw / 4.0)

    if train:
        assert fut_xy is not None and fut_mask is not None
        fut_xy = fut_xy.astype(jnp.float32)
        fut_mask = fut_mask.astype(jnp.float32)
        rel_fut = (fut_xy - origin[:, None]) * fut_mask[..., None]
        if inv_scale is not None:
            rel_fut = rel_fut * inv_scale[:, None]   # same per-agent scale
        hy, _ = encode_trajectory(p["enc_y"], p["embed_y"],
                                  rel_fut.astype(cd), fut_mask.astype(cd),
                                  dropout_key=kdy, keep_prob=kp,
                                  extra=enc_extra)
        mu, logvar = vae_encode(p, hx, hy, side)
        eps = jax.random.normal(key, (n, K, lat), hx.dtype)
        z = mu[:, None] + jnp.exp(0.5 * logvar)[:, None] * eps
        kp = int(round(K * cfg.prior_lane_frac))
        if kp > 0:
            # the first kp lanes sample the PRIOR during training
            # (config.py prior_lane_frac): the IOC ranker and the variety
            # loss see inference-like lane diversity
            eps_pr = eps if lt is None else eps * lt.astype(eps.dtype)
            if mu_p is not None:
                z_pr = (mu_p[:, None]
                        + jnp.exp(0.5 * logvar_p)[:, None] * eps_pr)
            else:
                z_pr = eps_pr
            z = jnp.concatenate([z_pr[:, :kp], z[:, kp:]], axis=1)
    else:
        mu = logvar = None
        eps = jax.random.normal(key, (n, K, lat), hx.dtype)
        if z_temp is not None:
            eps = eps * z_temp.astype(eps.dtype)
        if mu_p is not None:
            z = mu_p[:, None] + jnp.exp(0.5 * logvar_p)[:, None] * eps
        else:
            z = eps

    # K hypothesis lanes shard over the mesh 'k' axis (SURVEY §2.3: the
    # sequence-parallel analogue of this model); rows stay on 'data'.
    z = shard_hint(z, "data", "k")
    z_flat = z.reshape(n * K, lat)
    decode_mask = vae_decode_mask
    if cfg.remat:
        # the per-lane deconv stack materializes (N*K, 32, 32, C) maps —
        # gigabytes at K=50; recompute them in the backward pass (config.py
        # remat flag) instead of stashing
        decode_mask = jax.checkpoint(vae_decode_mask, static_argnums=(2,))
    beta, recon = decode_mask(p, z_flat, side)
    # additive z projection keeps a first-class linear path from the latent
    # into the decoder (see init_sgm z_skip comment); rho conditions the
    # seed with the temporal-conv trajectory features (C3 made live)
    h_seed = (beta * jnp.repeat(hx, K, axis=0)
              + L.dense(p["z_skip"], z_flat)
              + jnp.repeat(rho_seed, K, axis=0))
    h_init = jnp.repeat(hx_all, K, axis=1)                # (L, N*K, d)

    raw, dec_h = decode_hypotheses(p, cfg, h_seed, h_init, pred_len)
    raw = shard_hint(raw.reshape(n, K, pred_len, 5), "data", "k")
    dec_h = shard_hint(dec_h.reshape(n, K, pred_len, -1), "data", "k")
    cv_vel = mean_observed_velocity(rel_obs, obs_mask)    # (N, 2) f32
    # speed-adaptive residual bound (+ optional heading-frame anisotropy):
    # the head's tanh output scales with how fast this agent actually moves
    vel_bound, bound_c, heading = _residual_envelope(
        p, cfg, rel_obs, obs_mask, cv_vel)
    # position composition in f32 (see dtype note above); the decoder's raw
    # head outputs are the only compute_dtype input here
    raw5 = compose_positions(raw.astype(jnp.float32), origin[:, None, :],
                             cfg.vel_scale,
                             cv_vel=_lane_cv(p, cfg, cv_vel, dec_h),
                             vel_bound=vel_bound,
                             vel_bound_cross=bound_c, heading=heading)

    return {
        "raw5": raw5,                 # (N, K, Tf, 5) absolute-position gaussians
        "traj_mu": raw5[..., 0:2],    # (N, K, Tf, 2) mean trajectories
        "dec_h": dec_h,               # (N, K, Tf, d)
        "z_mu": mu, "z_logvar": logvar,
        "zp_mu": mu_p, "zp_logvar": logvar_p,
        "rho": rho, "hx": hx, "origin": origin,
        "beta": beta.reshape(n, K, -1),
    }
