"""Serving entry point: batched prefill + decode with the port's Engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi_6b \
        --batch 4 --prompt-len 4096 --new-tokens 64 --dsa --dsa-mode kernel

runs on the card (``--device cpu`` runs the plain PyTorch path on the
CPU; with ``--reduced`` that is the quick check).  Weights are random,
made from ``--seed``.  ``--dsa`` allocates the DSA predicted-key cache
(long-context decode); ``--dsa-mode kernel`` routes prefill through the
block-sparse kernel K2 and each decode step through the gather kernel K1.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs.base import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.inference.config import ServingConfig
from repro_torch.inference.engine import Engine
from repro_torch.models.transformer import init_model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--new-tokens", type=int, default=64)
    ap.add_argument("--max-len", type=int, default=0)
    ap.add_argument("--dsa", action="store_true",
                    help="DSA long-context decode (predicted-key cache)")
    ap.add_argument("--dsa-mode", default="block",
                    choices=["faithful", "block", "kernel"],
                    help="DSA path (with --dsa): token top-k (not ported) "
                         "| plain block gather | CUDA kernels")
    ap.add_argument("--loop", default="scan", choices=["scan", "python"],
                    help="back-to-back decode steps vs per-token host loop")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    params = init_model(args.seed, cfg, device=device)
    max_len = args.max_len or (args.prompt_len + args.new_tokens + 16)
    dsa_on = args.dsa and cfg.dsa.enabled
    config = ServingConfig(max_len=max_len, long_context=dsa_on,
                           dsa_mode=args.dsa_mode if dsa_on else "off",
                           loop=args.loop)
    eng = Engine(cfg, params, config=config, device=device)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(1, cfg.vocab - 4,
                           size=(args.batch, args.prompt_len)).astype(np.int32)
    res = eng.generate(prompts, args.new_tokens)
    print(f"prefill: {res.prefill_s * 1e3:.1f} ms   "
          f"decode: {res.decode_s:.2f} s   "
          f"throughput: {res.tokens_per_s:.1f} tok/s   "
          f"({res.decode_steps} steps in {res.decode_dispatches} "
          f"dispatch{'es' if res.decode_dispatches != 1 else ''})")
    print("first new tokens:", res.tokens[:, :8].tolist())
    return res


if __name__ == "__main__":
    main()
