"""Training entry point: the port of the reference's ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi_6b \
        --reduced --steps 20 --data needle --seq 128 --batch 8 --device cpu

trains on the card unless ``--device cpu`` is given.  Weights and data
are made from ``--seed`` (``repro_torch.data.synthetic``).  The loss is
the paper's joint objective (Eq. 7), accumulated over ``--microbatches``
slices of the batch, with AdamW on a warmup-cosine schedule
(``repro_torch.optim.adamw``).  ``--dsa-mode auto`` trains the DSA archs
on the block path; ``faithful`` and ``off`` train too, and ``kernel``
raises as the reference does (no kernel has a backward).  RWKV6 trains
through the differentiable chunked wkv, jamba's Mamba sub-blocks through
the selective scan, checkpointed per 128-token chunk (``models.ssm``).

With ``--ckpt-dir`` the state is saved (``repro_torch.checkpoint``, the
reference's format) every ``--save-interval`` steps in the background and
once more, blocking, at the end; ``--resume`` restores the latest
checkpoint there and prints ``[resume] from step N``.  Unlike the
reference, which replays the data from its first batch, a resumed run
draws and discards the N batches already consumed, so it is the
uninterrupted run (ROADMAP Queue 3).

It prints the reference's step lines (every ``--log-interval`` steps and
the last), its ``[done]`` line and, on the card, the median step time,
tokens/s and the peak memory.  Full-width archs recompute each layer in
the backward pass (``ArchConfig.remat``); ``--reduced`` ones do not.
``--layers N`` cuts the arch to its first N layers (a full-width
mixtral_8x22b layer holds 2.4 B expert parameters; deepseek_v3 keeps its
dense prologue, so ``--layers 3`` trains the prologue alone; jamba_1_5_large
keeps whole groups of 8 or one group's first N sub-blocks, so ``--layers
1`` trains one Mamba sub-block and a dense MLP) and ``--moment-dtype
bfloat16`` stores AdamW's moments in bf16.

Sharded training, as the reference's driver: ``--mesh host`` trains on
``fault_tolerance.elastic_mesh(model_parallel=1)`` under
``make_rules(fsdp=False, seq_parallel=False)`` (data parallelism over
every process; at one process, the run above), ``--mesh production`` and
``--mesh multipod`` on ``launch.mesh.make_production_mesh`` (16 x 16,
or 2 x 16 x 16 processes) under ``make_rules(multi_pod=...)`` (FSDP x
TP x SP); another world size raises ``ValueError``.  One process a
device, each running this same command: under ``torchrun``, which sets
RANK / WORLD_SIZE / LOCAL_RANK, or with ``--nodes``, ``--node-id`` and
``--coordinator`` per process; ``--backend`` as ``launch.serve``'s
(NCCL on the card, gloo on the CPU or for processes sharing one card).
Every rank draws the same global batch and keeps its rows; rank 0
prints; every rank exits non-zero if any rank fails.  On 8 cards:

    PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \
        --arch yi_6b --mesh host --steps 100 --seq 4096 --batch 16

``train(args, mesh, rules)`` is the run itself, on any mesh and rule
table (the tests train the production rules on a (2, 2) host mesh).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import os
import statistics
import tempfile
import time
from typing import Dict, List

import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpoint import AsyncCheckpointer
from repro_torch.configs.base import cut_layers, get_config, reduced
from repro_torch.data.synthetic import DataConfig, make_batches
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import StepWatchdog, elastic_mesh
from repro_torch.distributed.sharding import make_rules
from repro_torch.launch.mesh import (check_production_world,
                                     init_serving_processes,
                                     make_production_mesh)
from repro_torch.models.attention import RunFlags
from repro_torch.optim import adamw
from repro_torch.training import steps as ST

# seconds a collective waits for a peer before the rank fails
PEER_TIMEOUT_S = 600.0


@dataclasses.dataclass
class TrainResult:
    state: Dict
    metrics: List[Dict[str, float]]  # per step
    step_s: List[float]              # wall seconds per step, host clock


def parse_args(argv=None) -> argparse.Namespace:
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
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the arch to its first N layers (0 = all)")
    ap.add_argument("--moment-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="AdamW moment storage dtype")
    ap.add_argument("--mesh", default="host",
                    choices=["host", "production", "multipod"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--save-interval", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-interval", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--nodes", type=int, default=1,
                    help="processes of the run, one a device, each "
                         "started with its own --node-id (torchrun's "
                         "WORLD_SIZE / RANK / LOCAL_RANK take precedence)")
    ap.add_argument("--coordinator", default="127.0.0.1:12321",
                    help="host:port of process 0 (or an init_method URL, "
                         "e.g. file:///path) for --nodes > 1")
    ap.add_argument("--node-id", type=int, default=0,
                    help="this process's rank in [0, --nodes)")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="process-group backend (default nccl on the card; "
                         "the CPU needs an explicit gloo)")
    return ap.parse_args(argv)


def main(argv=None) -> TrainResult:
    args = parse_args(argv)
    env = os.environ
    if "WORLD_SIZE" in env and "RANK" in env:        # launched by torchrun
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        local = int(env.get("LOCAL_RANK", 0))
        url = "env://"
    else:
        world, rank, local = args.nodes, args.node_id, None
        url = args.coordinator
    multi_pod = args.mesh == "multipod"
    if args.mesh != "host":
        check_production_world(world, multi_pod)
    elif world == 1:
        return train(args)
    backend = args.backend
    if backend is None:
        if args.device not in (None, "cuda") and not str(
                args.device).startswith("cuda"):
            raise SystemExit("a mesh on the CPU needs --backend gloo")
        backend = "nccl"
    if world == 1 and "://" not in url:
        url = "file://" + os.path.join(tempfile.mkdtemp(), "store")
    init_serving_processes(url, world, rank, local, backend=backend,
                           timeout_s=PEER_TIMEOUT_S)
    try:
        quiet = (contextlib.nullcontext() if rank == 0
                 else contextlib.redirect_stdout(io.StringIO()))
        with quiet:
            if args.mesh == "host":
                mesh = elastic_mesh(model_parallel=1)
                rules = make_rules(fsdp=False, seq_parallel=False)
            else:
                mesh = make_production_mesh(multi_pod=multi_pod)
                rules = make_rules(multi_pod=multi_pod)
            sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape)))
            print(f"training mesh: {sizes} over {world} processes "
                  f"({backend})", flush=True)
            res = train(args, mesh, rules)
        # every rank waits here: one that failed earlier never arrives,
        # and the others' collective fails instead of returning 0
        dist.barrier()
        return res
    finally:
        dist.destroy_process_group()


def train(args: argparse.Namespace, mesh=None, rules=None) -> TrainResult:
    """The run of ``main``: ``args`` from ``parse_args``, on ``mesh``
    under ``rules`` (None: one device, no collective)."""
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.layers:
        cfg = cut_layers(cfg, args.layers)
    dsa_mode = args.dsa_mode
    if dsa_mode == "auto":
        dsa_mode = "block" if cfg.dsa.enabled else "off"
    flags = RunFlags(mode="train", dsa_mode=dsa_mode)

    opt = adamw.OptConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(1, args.steps // 10),
                          moment_dtype=args.moment_dtype)
    data = make_batches(args.data, DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed))
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    train_step = ST.make_train_step(cfg, opt, flags,
                                    microbatches=args.microbatches,
                                    mesh=mesh, rules=rules)
    plan = train_step.plan
    state, _ = ST.init_train_state(args.seed, cfg, opt, device=dev,
                                   mesh=mesh, rules=rules)
    step0 = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = AsyncCheckpointer(args.ckpt_dir)
        if args.resume:
            restored, rstep = ckpt.restore_latest(state, dev, plan=plan)
            if restored is not None:
                state, step0 = restored, rstep
                print(f"[resume] from step {step0}", flush=True)
                for _ in range(step0):      # the batches already consumed
                    next(data)

    wd = StepWatchdog()
    history: List[Dict[str, float]] = []
    step_s: List[float] = []
    t_start = time.monotonic()
    for step in range(step0, args.steps):
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
        if ckpt and (step + 1) % args.save_interval == 0:
            ckpt.save(state, step + 1, plan=plan)
    if ckpt:
        ckpt.save(state, args.steps, block=True, plan=plan)
    dt = time.monotonic() - t_start
    ntok = args.steps - step0
    print(f"[done] {ntok} steps in {dt:.1f}s "
          f"({args.batch * args.seq * ntok / dt:.0f} tok/s)")
    if cuda and step_s:
        med = statistics.median(step_s[1:] or step_s)
        print(f"[card] {torch.cuda.get_device_name(dev)}: median step "
              f"{med * 1e3:.1f} ms over steps 2-{args.steps}, "
              f"{args.batch * args.seq / med:.0f} tok/s, peak memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB",
              flush=True)
    return TrainResult(state, history, step_s)


if __name__ == "__main__":
    main()
