#!/usr/bin/env python3
"""The joint loss over the first steps of full-width stablelm_3b, in the
JAX reference and in the port, on the CPU from the same weights and
batches: does the port's curve follow the reference's?

    JAX_PLATFORMS=cpu python3 scripts/train_curve.py [--layers 2]
        [--steps 4] [--batch 2] [--seq 512] [--seed 0]

stablelm_3b at its published widths (d 2560, 32 heads of 80, vocab
50304) with ``--layers`` layers, f32, no remat, DSA on the block path;
``lm`` batches from ``--seed``; AdamW with lr 3e-4, a one-step warmup and
``total_steps = --steps``.  The reference's ``init_train_state`` makes
the weights and the port gets them through ``repro_torch.convert``.  The
reference runs first and is freed before the port starts (a 2-layer
state is ~5 GB a side).  Prints each step's loss, ce, mse and grad_norm
for both and their largest relative difference.  Needs the JAX package:
it runs here, not on the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

KEYS = ("loss", "ce", "mse", "grad_norm")


def reference_curve(args, batches):
    import jax
    from repro.configs.base import get_config
    from repro.optim import adamw
    from repro.training import steps as ST
    cfg = dataclasses.replace(get_config("stablelm_3b"), n_layers=args.layers,
                              dtype="float32", param_dtype="float32",
                              remat=False)
    opt = adamw.OptConfig(lr=3e-4, total_steps=args.steps, warmup_steps=1)
    state, _ = ST.init_train_state(jax.random.PRNGKey(args.seed), cfg, opt)
    params = jax.tree.map(np.asarray, state["params"])
    step = jax.jit(ST.make_train_step(cfg, opt))
    curve = []
    for b in batches:
        t0 = time.monotonic()
        state, m = step(state, b)
        curve.append({k: float(m[k]) for k in KEYS})
        print(f"reference step {len(curve) - 1}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in curve[-1].items())
            + f" ({time.monotonic() - t0:.1f} s)", flush=True)
    return params, curve


def port_curve(args, params, batches):
    from repro_torch import convert
    from repro_torch.configs.base import get_config
    from repro_torch.optim import adamw
    from repro_torch.training import steps as ST
    from repro_torch.tree import named_leaves
    cfg = dataclasses.replace(get_config("stablelm_3b"), n_layers=args.layers,
                              dtype="float32", param_dtype="float32",
                              remat=False)
    opt = adamw.OptConfig(lr=3e-4, total_steps=args.steps, warmup_steps=1)
    p = convert.from_reference(params, device="cpu")
    for path, t in named_leaves(p):
        t.requires_grad_(not adamw.is_frozen(path))
    state = {"params": p, "opt": adamw.init(opt, p), "step": 0}
    step = ST.make_train_step(cfg, opt)
    curve = []
    for b in batches:
        t0 = time.monotonic()
        state, m = step(state, b)
        curve.append({k: float(m[k]) for k in KEYS})
        print(f"port      step {len(curve) - 1}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in curve[-1].items())
            + f" ({time.monotonic() - t0:.1f} s)", flush=True)
    return curve


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import DataConfig, lm_batches
    data = lm_batches(DataConfig(vocab=get_config("stablelm_3b").vocab,
                                 seq_len=args.seq, global_batch=args.batch,
                                 seed=args.seed))
    batches = [next(data) for _ in range(args.steps)]
    params, ref = reference_curve(args, batches)
    gc.collect()
    port = port_curve(args, params, batches)
    for i, (r, p) in enumerate(zip(ref, port)):
        rel = max(abs(p[k] - r[k]) / abs(r[k]) for k in KEYS)
        print(f"step {i}: loss reference {r['loss']:.4f} port "
              f"{p['loss']:.4f}; largest relative difference of "
              f"{'/'.join(KEYS)}: {rel:.2e}")


if __name__ == "__main__":
    main()
