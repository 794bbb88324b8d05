"""Training entry point: the port of the reference's ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi_6b \
        --reduced --steps 20 --data needle --seq 128 --batch 8 --device cpu

trains on the card unless ``--device cpu`` is given.  Weights and data
are made from ``--seed`` (``repro_torch.data.synthetic``).  The loss is
the paper's joint objective (Eq. 7), accumulated over ``--microbatches``
slices of the batch, with AdamW on a warmup-cosine schedule
(``repro_torch.optim.adamw``).  ``--dsa-mode auto`` trains the DSA archs
on the block path; ``faithful`` and ``off`` train too, and ``kernel``
raises as the reference does (no kernel has a backward).  RWKV6 does not
train yet (ROADMAP Queue 1, item 1).

It prints the reference's step lines (every ``--log-interval`` steps and
the last), its ``[done]`` line and, on the card, the median step time,
tokens/s and the peak memory.  Full-width archs recompute each layer in
the backward pass (``ArchConfig.remat``); ``--reduced`` ones do not.
Sharded training (``--mesh`` other than ``host``) and checkpoints
(``--ckpt-dir``, ``--resume``) are not ported (ROADMAP Queue 1, item 7).
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import time
from typing import Dict, List

import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.data.synthetic import DataConfig, make_batches
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import StepWatchdog
from repro_torch.models.attention import RunFlags
from repro_torch.optim import adamw
from repro_torch.training import steps as ST


@dataclasses.dataclass
class TrainResult:
    state: Dict
    metrics: List[Dict[str, float]]  # per step
    step_s: List[float]              # wall seconds per step, host clock


def main(argv=None) -> TrainResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--data", default="needle", choices=["needle", "lm"])
    ap.add_argument("--dsa-mode", default="auto",
                    choices=["auto", "off", "faithful", "block", "kernel"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh", default="host",
                    choices=["host", "production", "multipod"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-interval", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    if args.mesh != "host":
        raise NotImplementedError(
            f"--mesh {args.mesh}: sharded training is not ported (ROADMAP "
            f"Queue 1, item 7)")
    if args.ckpt_dir or args.resume:
        raise NotImplementedError(
            "--ckpt-dir/--resume: checkpoints are not ported (ROADMAP Queue "
            "1, item 7)")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    dsa_mode = args.dsa_mode
    if dsa_mode == "auto":
        dsa_mode = "block" if cfg.dsa.enabled else "off"
    flags = RunFlags(mode="train", dsa_mode=dsa_mode)

    opt = adamw.OptConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(1, args.steps // 10))
    data = make_batches(args.data, DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed))
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    state = ST.init_train_state(args.seed, cfg, opt, device=dev)
    train_step = ST.make_train_step(cfg, opt, flags,
                                    microbatches=args.microbatches)

    wd = StepWatchdog()
    history: List[Dict[str, float]] = []
    step_s: List[float] = []
    t_start = time.monotonic()
    for step in range(args.steps):
        batch = next(data)
        wd.start()
        state, metrics = train_step(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}   # syncs
        slow = wd.stop(step)
        step_s.append(wd.times[-1])
        history.append(metrics)
        if slow:
            print(f"[watchdog] straggler at step {step}: "
                  f"{wd.times[-1]:.2f}s vs median {wd.median_step_s:.2f}s")
        if step % args.log_interval == 0 or step == args.steps - 1:
            print(f"step {step}: loss={metrics['loss']:.4f} "
                  f"ce={metrics['ce']:.4f} mse={metrics['mse']:.4f} "
                  f"gnorm={metrics['grad_norm']:.2f}", flush=True)
    dt = time.monotonic() - t_start
    print(f"[done] {args.steps} steps in {dt:.1f}s "
          f"({args.batch * args.seq * args.steps / dt:.0f} tok/s)")
    if cuda:
        med = statistics.median(step_s[1:] or step_s)
        print(f"[card] {torch.cuda.get_device_name(dev)}: median step "
              f"{med * 1e3:.1f} ms over steps 2-{args.steps}, "
              f"{args.batch * args.seq / med:.0f} tok/s, peak memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB",
              flush=True)
    return TrainResult(state, history, step_s)


if __name__ == "__main__":
    main()
