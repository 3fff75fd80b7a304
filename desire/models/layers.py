"""Functional neural-net layers with explicit parameter pytrees.

Deliberately framework-light: every layer is an ``init_*(key, ...) -> params``
plus a pure ``apply`` function over jnp arrays. This keeps the parameter tree
a plain nested dict — trivially shardable with jax.sharding and
checkpointable as a flat key-path archive (train/checkpoint.py).

Capability map to the reference:
* gru_*        -> TF GRUCell stacks (model/model.py:136-148); fused-matmul
                  gate formulation (one (in+h)x3h matmul per step)
* conv/deconv  -> the prettytensor conv-VAE stacks (model/model.py:453-492,
                  utils/convolutional_vae_util.py); batchnorm replaced with
                  GroupNorm (documented deviation: phase-free, vmap-safe)
* dense        -> tf.nn.xw_plus_b fusion layers (model/model.py:248-251)
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

Params = dict


def _uniform_limit(fan_in: int, fan_out: int) -> float:
    return math.sqrt(6.0 / (fan_in + fan_out))


def glorot(key, shape, dtype=jnp.float32):
    """Xavier/Glorot uniform — the init the reference's prettytensor layers
    used (utils/convolutional_vae_util.py:60-63). Fans are computed with
    static python math so init_* trees can be built under jit (one dispatch
    instead of ~40)."""
    fan_in = math.prod(shape[:-1])
    fan_out = int(shape[-1])
    lim = _uniform_limit(fan_in, fan_out)
    return jax.random.uniform(key, shape, dtype, -lim, lim)


# -- dense ------------------------------------------------------------------

def init_dense(key, in_dim, out_dim, dtype=jnp.float32, scale=1.0) -> Params:
    kw, _ = jax.random.split(key)
    return {"w": glorot(kw, (in_dim, out_dim), dtype) * scale,
            "b": jnp.zeros((out_dim,), dtype)}


def dense(p: Params, x: jnp.ndarray) -> jnp.ndarray:
    return jnp.dot(x, p["w"].astype(x.dtype),
                   preferred_element_type=x.dtype) + p["b"].astype(x.dtype)


# -- GRU ----------------------------------------------------------------------
# Gate layout along the 3h axis: [r | z | n] (reset, update, candidate).
# h' = (1-z)*n + z*h with n = tanh(x_n + r * h_n)  (cuDNN/flax variant).

def init_gru(key, in_dim, hidden, dtype=jnp.float32) -> Params:
    k1, k2 = jax.random.split(key)
    return {
        "wi": glorot(k1, (in_dim, 3 * hidden), dtype),
        "wh": glorot(k2, (hidden, 3 * hidden), dtype),
        "bi": jnp.zeros((3 * hidden,), dtype),
        "bh": jnp.zeros((3 * hidden,), dtype),
    }


def gru_step(p: Params, h: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """One GRU step. h: (..., H), x: (..., in). Returns h'."""
    gi = jnp.dot(x, p["wi"].astype(x.dtype),
                 preferred_element_type=x.dtype) + p["bi"].astype(x.dtype)
    gh = jnp.dot(h, p["wh"].astype(h.dtype),
                 preferred_element_type=h.dtype) + p["bh"].astype(h.dtype)
    i_r, i_z, i_n = jnp.split(gi, 3, axis=-1)
    h_r, h_z, h_n = jnp.split(gh, 3, axis=-1)
    r = jax.nn.sigmoid(i_r + h_r)
    z = jax.nn.sigmoid(i_z + h_z)
    n = jnp.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def gru_scan(p: Params, h0: jnp.ndarray, xs: jnp.ndarray,
             mask: jnp.ndarray | None = None, reverse: bool = False):
    """Scan a GRU over time.

    xs: (T, N, in); h0: (N, H); mask: (T, N) — masked steps carry the state
    through unchanged (the vectorized equivalent of the reference's id==0
    skip semantics). Returns (h_T, hs) with hs: (T, N, H).
    """
    def body(h, inp):
        if mask is None:
            x = inp
            h_new = gru_step(p, h, x)
        else:
            x, m = inp
            h_new = gru_step(p, h, x)
            h_new = jnp.where(m[..., None] > 0, h_new, h)
        return h_new, h_new

    inputs = xs if mask is None else (xs, mask)
    return jax.lax.scan(body, h0, inputs, reverse=reverse)


def gru_scan_const_x(p: Params, h0: jnp.ndarray, x: jnp.ndarray, t_len: int):
    """GRU scan whose input is the SAME x at every step (the K-lane decoder's
    seed-fed recurrence, reference rnn_decoder semantics model/model.py:279-289
    — `[multipl ⊙ enc_x] * K` feeds the identical vector each step).

    The input-gate matmul x@Wi is time-invariant, so it hoists OUT of the
    scan — one (N, in)@(in, 3H) matmul instead of T of them; the scan carries
    only the h@Wh recurrence. Bit-identical to gru_scan on broadcast inputs
    (same op order per step). Returns (h_T, hs (T, N, H))."""
    gi = jnp.dot(x, p["wi"].astype(x.dtype),
                 preferred_element_type=x.dtype) + p["bi"].astype(x.dtype)
    i_r, i_z, i_n = jnp.split(gi, 3, axis=-1)

    def body(h, _):
        gh = jnp.dot(h, p["wh"].astype(h.dtype),
                     preferred_element_type=h.dtype) + p["bh"].astype(h.dtype)
        h_r, h_z, h_n = jnp.split(gh, 3, axis=-1)
        r = jax.nn.sigmoid(i_r + h_r)
        z = jax.nn.sigmoid(i_z + h_z)
        n = jnp.tanh(i_n + r * h_n)
        h_new = (1.0 - z) * n + z * h
        return h_new, h_new

    return jax.lax.scan(body, h0, None, length=t_len)


def init_gru_stack(key, in_dim, hidden, num_layers, dtype=jnp.float32):
    keys = jax.random.split(key, num_layers)
    return [init_gru(keys[i], in_dim if i == 0 else hidden, hidden, dtype)
            for i in range(num_layers)]


def gru_stack_scan(stack, h0s, xs, mask=None):
    """Multi-layer GRU (reference MultiRNNCell, model/model.py:138-141).
    h0s: (L, N, H). Returns (h_finals (L,N,H), top-layer hs (T,N,H))."""
    finals = []
    cur = xs
    for layer, p in enumerate(stack):
        hT, cur = gru_scan(p, h0s[layer], cur, mask=mask)
        finals.append(hT)
    return jnp.stack(finals), cur


# -- conv / deconv ------------------------------------------------------------

def init_conv(key, kh, kw, cin, cout, dtype=jnp.float32) -> Params:
    return {"w": glorot(key, (kh, kw, cin, cout), dtype),
            "b": jnp.zeros((cout,), dtype)}


def conv2d(p: Params, x: jnp.ndarray, stride=1, padding="SAME") -> jnp.ndarray:
    """x: (N, H, W, C)."""
    y = jax.lax.conv_general_dilated(
        x, p["w"].astype(x.dtype),
        window_strides=(stride, stride), padding=padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=x.dtype)
    return y + p["b"].astype(x.dtype)


def deconv2d(p: Params, x: jnp.ndarray, stride=1, padding="SAME") -> jnp.ndarray:
    """Transposed conv (reference's vendored prettytensor deconv2d op,
    utils/convolutional_vae_util.py:31-135). x: (N, H, W, Cin),
    w: (kh, kw, Cin, Cout)."""
    y = jax.lax.conv_transpose(
        x, p["w"].astype(x.dtype),
        strides=(stride, stride), padding=padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=x.dtype)
    return y + p["b"].astype(x.dtype)


# -- group norm ---------------------------------------------------------------
# Replaces prettytensor's batchnorm in the VAE stacks (model/model.py:457-462):
# batch-independent, no train/eval phase, safe under vmap/sharding.

def init_groupnorm(channels, dtype=jnp.float32) -> Params:
    return {"scale": jnp.ones((channels,), dtype),
            "bias": jnp.zeros((channels,), dtype)}


def groupnorm(p: Params, x: jnp.ndarray, groups=8, eps=1e-5) -> jnp.ndarray:
    c = x.shape[-1]
    g = min(groups, c)
    while c % g:
        g -= 1
    shape = x.shape[:-1] + (g, c // g)
    xg = x.reshape(shape)
    mean = xg.mean(axis=(-1,) + tuple(range(1, x.ndim - 1)), keepdims=True)
    var = xg.var(axis=(-1,) + tuple(range(1, x.ndim - 1)), keepdims=True)
    xg = (xg - mean) * jax.lax.rsqrt(var + eps)
    return xg.reshape(x.shape) * p["scale"].astype(x.dtype) + p["bias"].astype(x.dtype)
