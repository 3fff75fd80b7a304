"""Scene Context Fusion (SCF).

The DESIRE paper's IOC stage fuses, per hypothesis step: (1) the decoder's
dynamics, (2) scene CNN features pooled at the *predicted* position, and
(3) a social pooling of interacting agents. The reference never built this —
its "feature pooling" stand-in (model/model.py:291-311) multiplies decoder
outputs into halves of the temporal-conv vector; SURVEY §7.4 flags it as an
unfinished design to be rebuilt from the paper. This module is that rebuild.

Since SDD ships no imagery in the reference data layout, the scene feature
map is *learned from agent occupancy*: observed positions of all agents are
rasterized onto a G x G grid, a small CNN turns that into a feature map, and
hypothesis positions bilinearly pool from it. (With camera imagery available,
the raster simply gains image channels — the fusion machinery is unchanged.)

Shapes: rasterization is a scatter-add on a (B, G*G, C) buffer; pooling is
4 gathers + lerp (bilinear); social pooling is distance-kernel attention over
the agent axis — a batched (A x A) softmax and matmul.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from desire.config import DesireConfig
from desire.models import layers as L


def init_scf(key, cfg: DesireConfig, dtype=jnp.float32) -> dict:
    ks = jax.random.split(key, 4)
    c = cfg.scene_channels
    c_in = 2 + cfg.scene_image_channels   # occupancy planes (+ imagery)
    return {
        "conv1": L.init_conv(ks[0], 3, 3, c_in, c, dtype),
        "gn1": L.init_groupnorm(c, dtype),
        "conv2": L.init_conv(ks[1], 3, 3, c, c, dtype),
        "gn2": L.init_groupnorm(c, dtype),
        # social attention: project decoder hidden -> social message
        "soc_msg": L.init_dense(ks[2], cfg.d_dim, cfg.d_dim, dtype),
        # learned temperature for the distance kernel
        "soc_logtau": jnp.zeros((), dtype),
    }


def rasterize_occupancy(obs_xy, obs_mask, grid):
    """(B, To, A, 2) normalized positions -> (B, G, G, 2) raster:
    channel 0 = time-integrated occupancy, channel 1 = last-step occupancy.

    Bilinear *splat* onto grid nodes at pos*(G-1) — the exact adjoint of
    bilinear_pool's align-corners sampling, so occupancy is written at the
    same grid locations hypotheses later pool from (a floor(pos*G) cell
    convention here was misaligned with the node convention by up to half a
    cell)."""
    b, t, a, _ = obs_xy.shape
    xy = jnp.clip(obs_xy, 0.0, 1.0) * (grid - 1)
    x0 = jnp.floor(xy[..., 0]);  y0 = jnp.floor(xy[..., 1])
    fx = xy[..., 0] - x0;        fy = xy[..., 1] - y0
    x0i = x0.astype(jnp.int32);  y0i = y0.astype(jnp.int32)
    x1i = jnp.minimum(x0i + 1, grid - 1)
    y1i = jnp.minimum(y0i + 1, grid - 1)

    last = jnp.zeros_like(obs_mask).at[:, -1].set(obs_mask[:, -1])
    w = jnp.stack([obs_mask, last], -1)                   # (B, To, A, 2)
    flat = jnp.zeros((b, grid * grid, 2), obs_xy.dtype)
    bidx = jnp.arange(b)[:, None, None]
    for yy, xx, cw in ((y0i, x0i, (1 - fx) * (1 - fy)),
                       (y0i, x1i, fx * (1 - fy)),
                       (y1i, x0i, (1 - fx) * fy),
                       (y1i, x1i, fx * fy)):
        flat = flat.at[bidx, yy * grid + xx].add(w * cw[..., None])
    return (flat / t).reshape(b, grid, grid, 2)


def scene_feature_map(p, obs_xy, obs_mask, grid, compute_dtype="float32",
                      image=None):
    """Occupancy raster (+ optional imagery channels) -> CNN -> (B, G, G, C).

    Rasterization runs in the (f32) position dtype for exact splat weights;
    the CNN runs in compute_dtype (the raster values are O(1) occupancy
    densities — bf16-safe).

    image: optional (B, G, G, Ci) per-scene raster (camera imagery resampled
    to the feature grid; the paper's scene-CNN input) concatenated into the
    occupancy channels — init_scf must have been built with
    cfg.scene_image_channels == Ci."""
    raster = rasterize_occupancy(obs_xy.astype(jnp.float32),
                                 obs_mask.astype(jnp.float32), grid)
    if image is not None:
        assert image.shape[1:3] == raster.shape[1:3], (
            f"scene image {image.shape} must match the {grid}x{grid} grid")
        raster = jnp.concatenate(
            [raster, image.astype(raster.dtype)], axis=-1)
    cd = jnp.bfloat16 if compute_dtype == "bfloat16" else jnp.float32
    raster = raster.astype(cd)
    h = jax.nn.relu(L.groupnorm(p["gn1"], L.conv2d(p["conv1"], raster)))
    h = jax.nn.relu(L.groupnorm(p["gn2"], L.conv2d(p["conv2"], h)))
    return h


def bilinear_pool(feat_map, pos):
    """Bilinearly sample (B, G, G, C) at positions (B, ..., 2) in [0,1].
    Returns (B, ..., C)."""
    b, g, _, c = feat_map.shape
    flat = feat_map.reshape(b, g * g, c)
    xy = jnp.clip(pos, 0.0, 1.0) * (g - 1)
    x0 = jnp.floor(xy[..., 0]);  y0 = jnp.floor(xy[..., 1])
    fx = xy[..., 0] - x0;        fy = xy[..., 1] - y0
    x0 = x0.astype(jnp.int32);   y0 = y0.astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, g - 1)
    y1 = jnp.minimum(y0 + 1, g - 1)

    def gather(yy, xx):
        idx = (yy * g + xx).reshape(b, -1)                # (B, P)
        out = jnp.take_along_axis(flat, idx[..., None], axis=1)
        return out.reshape(pos.shape[:-1] + (c,))

    w00 = ((1 - fx) * (1 - fy))[..., None]
    w01 = (fx * (1 - fy))[..., None]
    w10 = ((1 - fx) * fy)[..., None]
    w11 = (fx * fy)[..., None]
    return (gather(y0, x0) * w00 + gather(y0, x1) * w01 +
            gather(y1, x0) * w10 + gather(y1, x1) * w11)


def social_messages(p, dec_h):
    """Project decoder hiddens to social messages once per IOC pass (the
    hiddens don't change across refinement iterations)."""
    return L.dense(p["soc_msg"], dec_h)                   # (B, A, K, Tf, d)


def social_pool(p, traj, msg, live):
    """Distance-kernel attention over agents, per hypothesis lane and step.

    traj: (B, A, K, Tf, 2) current hypothesis positions
    msg:  (B, A, K, Tf, d) social messages (social_messages())
    live: (B, A) agent validity
    Returns (B, A, K, Tf, d): for each agent, the kernel-weighted sum of the
    *other* live agents' messages at the same lane/step.

    Matmul formulation: d2(i,j) = |y_i|^2 + |y_j|^2 - 2 y_i.y_j via a batched
    (A,2)@(2,A) matmul, and the weighted sum is a batched (A,A)@(A,d) matmul —
    the naive broadcast-diff materializes a (B,A,A,K,Tf,2) tensor (~0.4 GB at
    flagship shapes).
    """
    b, a, k, tf, d = msg.shape
    traj = traj.astype(msg.dtype)  # distances feed a softmax kernel: cd-safe
    y = jnp.moveaxis(traj, 1, 3).reshape(b, k * tf, a, 2)   # (B, KT, A, 2)
    m = jnp.moveaxis(msg, 1, 3).reshape(b, k * tf, a, d)    # (B, KT, A, d)
    sq = jnp.sum(y * y, axis=-1)                            # (B, KT, A)
    gram = jnp.einsum("bsic,bsjc->bsij", y, y,
                      preferred_element_type=y.dtype)       # (B, KT, A, A)
    d2 = sq[..., :, None] + sq[..., None, :] - 2.0 * gram
    tau = jnp.exp(p["soc_logtau"]).astype(d2.dtype) + 1e-4
    logits = -d2 / tau
    eye = jnp.eye(a, dtype=bool)
    livej = (live[:, None, None, :] > 0)                    # (B,1,1,A)
    logits = jnp.where(eye | ~livej, -1e9, logits)
    w = jax.nn.softmax(logits, axis=-1)                     # (B, KT, A, A)
    # zero rows with no live neighbors (softmax over all -1e9 is uniform)
    any_nb = jnp.sum((~eye & livej).astype(d2.dtype), axis=-1) > 0
    w = w * any_nb[..., None]
    out = jnp.einsum("bsij,bsjd->bsid", w, m,
                     preferred_element_type=m.dtype)        # (B, KT, A, d)
    return jnp.moveaxis(out.reshape(b, k, tf, a, d), 3, 1)


def fuse_context(p, cfg: DesireConfig, traj, msg, feat_map, live,
                 social=None):
    """The SCF vectors per (agent, lane, step): (velocity, scene, social).

    traj (B,A,K,Tf,2), msg = social_messages(dec_h) -> a TUPLE of
    (B,A,K,Tf,2), (B,A,K,Tf,scene_channels), (B,A,K,Tf,d_dim) — deliberately
    NOT concatenated: the only consumer (the IOC score GRU) projects them
    through its input-gate matrix, and that projection distributes over the
    blocks — three matmuls beat materializing a (B·A·K·Tf, 82) tensor.

    traj arrives f32 (exact positions); blocks are returned in feat_map's
    compute dtype for the downstream GRU.

    social: optional precomputed social block (config.py social_freeze:
    pools attended once at the initial positions and reused per refinement
    pass) — when given, social_pool is skipped."""
    vel = jnp.diff(traj, axis=-2, prepend=traj[..., :1, :]).astype(msg.dtype)
    b, a, k, tf, _ = traj.shape
    scene = bilinear_pool(feat_map, traj.reshape(b, a * k * tf, 2))
    # f32 positions x bf16 features promote — pin the block dtype back
    scene = scene.reshape(b, a, k, tf, -1).astype(msg.dtype)
    if social is None and cfg.use_social:
        social = social_pool(p, traj, msg, live)
    return vel, scene, social
