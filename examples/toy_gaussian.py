#!/usr/bin/env python
"""Minimal worked example — capability parity with the reference's toy
prototyping script (/root/reference/tryout.py:92-143 and
desire/model/encode_trajectories.py): a per-step dense layer mapping each
agent's position to a bivariate Gaussian over the next position, trained
with the masked NLL. ~40 lines of actual model code, and unlike the
reference's version it runs (tryout.py never created its session,
SURVEY §8) and trains the whole batch in one jitted step.

  python examples/toy_gaussian.py [--data_dir /root/reference/data --scenes coupa]
"""

import argparse
import os
import sys

import jax
import jax.numpy as jnp
import optax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from desire.config import DesireConfig  # noqa: E402
from desire.data.loader import SDDLoader  # noqa: E402
from desire.models import layers as L  # noqa: E402
from desire.models import losses  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", default="data/")
    ap.add_argument("--scenes", default="")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--platform", default="")
    args = ap.parse_args(argv)
    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    cfg = DesireConfig(batch_size=32, max_num_obj=16, obs_len=4, pred_len=1,
                       data_dir=args.data_dir, scenes=args.scenes,
                       window_hop=4)
    loader = SDDLoader(cfg)

    # toy model: dense(2 -> 5) per step (tryout.py:109-120's "hidden layer")
    params = {"head": L.init_dense(jax.random.PRNGKey(0), 2, 5)}
    tx = optax.rmsprop(1e-3)  # the reference toy used RMSProp (tryout.py:140)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, xy, mask, ids):
        def loss_fn(p):
            cur, nxt = xy[:, -2], xy[:, -1]           # (B, A, 2) each
            m = mask[:, -2] * mask[:, -1] * (ids > 0)
            raw = L.dense(p["head"], cur)             # (B, A, 5)
            # predict the next-step *offset* gaussian
            tgt = nxt - cur
            nll = losses.bivariate_nll(raw, tgt)
            return losses.masked_mean(nll, m)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    it = None
    for i in range(args.steps):
        if it is None:
            it = loader.epoch_batches(i // max(loader.num_batches, 1))
        try:
            b = next(it)
        except StopIteration:
            it = None
            continue
        params, opt_state, loss = step(
            params, opt_state, jnp.asarray(b.xy), jnp.asarray(b.mask),
            jnp.asarray(b.ids, jnp.float32))
        if i % 20 == 0:
            print(f"step {i:4d}  nll {float(loss):8.4f}")
    print("final nll:", float(loss))


if __name__ == "__main__":
    main()
