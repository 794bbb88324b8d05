"""Serving entry point: batched prefill + decode with the port's Engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi_6b \
        --batch 4 --prompt-len 4096 --new-tokens 64 --dsa --dsa-mode kernel

runs on the card (``--device cpu`` runs the plain PyTorch path on the
CPU; with ``--reduced`` that is the quick check).  Weights are random,
made from ``--seed``.  ``--dsa`` allocates the DSA predicted-key cache
(long-context decode); ``--dsa-mode kernel`` routes prefill through the
block-sparse kernel K2 and each decode step through the gather kernel K1.

``--continuous`` serves a synthetic open-loop Poisson stream of
``--requests`` mixed-length requests at ``--rate`` req/s through the
continuous-batching engine (repro_torch.inference.scheduler): a resident
``--slots``-slot cache, decode segments of ``--seg-len`` steps, chunked
admission in ``--chunk-tokens``-wide chunks (the chunk kernel K3 on
``--dsa-mode kernel``), and with ``--paged`` a paged resident cache over
``--pool-pages`` pages (decode through K4):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi_6b \
        --reduced --continuous --paged --dsa --dsa-mode kernel \
        --requests 6 --slots 2 --prompt-len 64 --new-tokens 8 --device cpu

``--kv-quant int8|fp8`` stores the K/V caches narrow with per-row scales
(the quantized kernels K1q, K3q, K4q) and ``--select-dtype int8`` (with
``--dsa``) the DSA selection caches; the run prints the resident cache's
bytes per slot (per batch row on the static path):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi_6b \
        --reduced --continuous --paged --dsa --dsa-mode kernel \
        --kv-quant int8 --select-dtype int8 --requests 6 --slots 2 \
        --prompt-len 64 --new-tokens 8 --device cpu

On the card each decode step of the static ``--loop scan`` path and of
the continuous engine's segments is one replay of the step's CUDA graph
(repro_torch.inference.graphs); both lines print the graphs captured and
replayed, and the kernels' launch counts include the replays.

``--dsa-mode faithful`` is the paper's own token granularity: prefill
through the token path (a (B, L, L) top-k mask, no kernel) and each
decode step through a top-k over all the cache's predicted scores, in
plain PyTorch on every device (the reference runs it through XLA too).

``--arch h2o_danube_1_8b`` serves a sliding-window model: its cache is a
ring of min(max_len, 4096) rows (the cache line reports its bytes), a
prompt longer than the window wraps it at prefill, prefill with ``--dsa
--dsa-mode kernel`` runs K2 with the window once per layer, and decode
attends the ring with plain PyTorch (an SWA cache has no predicted-key
cache, as in the reference); ``--continuous`` admits it blocking:

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch h2o_danube_1_8b --reduced --batch 2 --prompt-len 160 \
        --new-tokens 8 --dsa --dsa-mode kernel --device cpu

``--arch rwkv6_3b`` serves the RWKV6 model through the static engine: its
prefill runs the chunked wkv kernel K7 once per layer when the prompt is
a multiple of 32 longer than 32; ``--dsa`` falls back to off (no score
matrix), and the cache line reports the recurrent state's bytes:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6_3b \
        --reduced --batch 2 --prompt-len 64 --new-tokens 8 --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.inference.config import ServingConfig
from repro_torch.inference.engine import Engine
from repro_torch.inference.scheduler import (ContinuousEngine, summarize,
                                             synthetic_workload)
from repro_torch.kernels.dsa_attention import dsa_block_sparse_attention
from repro_torch.kernels.dsa_chunk_prefill import (
    dsa_chunk_gather_attention, dsa_chunk_paged_gather_attention)
from repro_torch.kernels.dsa_decode import (dsa_decode_gather_attention,
                                            dsa_decode_paged_gather_attention)
from repro_torch.kernels.wkv6 import wkv6_chunked
from repro_torch.models.attention import RunFlags, cache_page_size
from repro_torch.models.transformer import init_cache, init_model

# the kernels whose launch counts a run reports: (wrapper, counter)
KERNELS = {"K1": (dsa_decode_gather_attention, "launches"),
           "K2": (dsa_block_sparse_attention, "launches"),
           "K3": (dsa_chunk_gather_attention, "launches"),
           "K4": (dsa_decode_paged_gather_attention, "launches"),
           "K5": (dsa_chunk_paged_gather_attention, "launches"),
           "K1q": (dsa_decode_gather_attention, "launches_quant"),
           "K3q": (dsa_chunk_gather_attention, "launches_quant"),
           "K4q": (dsa_decode_paged_gather_attention, "launches_quant"),
           "K5q": (dsa_chunk_paged_gather_attention, "launches_quant"),
           "K7": (wkv6_chunked, "launches")}


def launch_counts() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn, attr in KERNELS.values():
        setattr(fn, attr, 0)


def graph_counts(graphs) -> tuple:
    """(captures, replays) of an engine's decode graphs; (0, 0) on the
    CPU, which has none."""
    return (0, 0) if graphs is None else (graphs.captures, graphs.replays)


def cache_bytes(caches) -> int:
    """Bytes held by every tensor of a cache tree."""
    if isinstance(caches, dict):
        return sum(cache_bytes(v) for v in caches.values())
    if isinstance(caches, list):
        return sum(cache_bytes(v) for v in caches)
    return caches.numel() * caches.element_size()


def _serve_continuous(cfg, args, params, config, device):
    """Serve the synthetic workload; returns (results, engine)."""
    eng = ContinuousEngine(cfg, params, config=config, device=device)
    workload = synthetic_workload(
        args.requests, rate_rps=args.rate,
        prompt_lens=(max(8, args.prompt_len // 4), args.prompt_len),
        n_new_range=(max(2, args.new_tokens // 4), args.new_tokens),
        vocab=cfg.vocab, seed=args.seed)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    before = launch_counts()
    graphs = graph_counts(eng.graphs)
    results = eng.serve(workload)
    wall = max((r.finish_s for r in results), default=0.0)
    s = summarize(results, wall)
    captures, replays = (b - a for a, b in zip(graphs,
                                               graph_counts(eng.graphs)))
    print(f"continuous: {s['n_requests']} requests, "
          f"{s['delivered_tokens']} tokens in {s['wall_s']:.2f} s -> "
          f"{s['goodput_tok_s']:.1f} tok/s goodput, "
          f"p50 {s['p50_latency_s']:.2f} s / p95 {s['p95_latency_s']:.2f} s "
          f"latency ({int(eng.stats['segments'])} segments, "
          f"{int(eng.stats['admitted'])} admissions; decode graphs: "
          f"{captures} captured, {replays} replays)")
    after = launch_counts()
    peak = (f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB"
            if device.type == "cuda" else "not measured (CPU)")
    print(f"  p50 TTFT {s['p50_ttft_s']:.2f} s, {eng.stats['chunks']} "
          f"chunk steps, {eng.stats['decode_steps']} decode steps, "
          f"launches " + " ".join(f"{k} {after[k] - before[k]}"
                                  for k in KERNELS)
          + f", peak memory {peak}, resident cache "
          f"{cache_bytes(eng._caches) // eng.slots} bytes per slot")
    return results, eng


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
                    help="DSA path (with --dsa): token top-k "
                         "| plain block gather | CUDA kernels")
    ap.add_argument("--loop", default="scan", choices=["scan", "python"],
                    help="back-to-back decode steps vs per-token host loop")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching serving loop over an "
                         "open-loop Poisson arrival process")
    ap.add_argument("--slots", type=int, default=0,
                    help="resident slots for --continuous (default: --batch)")
    ap.add_argument("--seg-len", type=int, default=16,
                    help="decode steps per segment (--continuous)")
    ap.add_argument("--requests", type=int, default=16,
                    help="synthetic requests to serve (--continuous)")
    ap.add_argument("--rate", type=float, default=4.0,
                    help="Poisson arrival rate, requests/s (--continuous)")
    ap.add_argument("--chunk-tokens", type=int, default=64,
                    help="chunked admission width in tokens (--continuous)")
    ap.add_argument("--paged", action="store_true",
                    help="page the resident KV cache over a shared page "
                         "pool (--continuous)")
    ap.add_argument("--pool-pages", type=int, default=0,
                    help="physical pages in the paged pool (0 = enough "
                         "for every slot at max_len)")
    ap.add_argument("--select-dtype", default="float32",
                    choices=["float32", "int8"],
                    help="DSA selection precision (with --dsa): int8 stores "
                         "the predicted-key caches quantized with per-row "
                         "scales and runs the selection product in integers")
    ap.add_argument("--kv-quant", default=None, choices=["int8", "fp8"],
                    help="quantized K/V cache storage dtype with per-row "
                         "scales, dequantized on gather (default: off)")
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
    if args.paged:
        page = cache_page_size(cfg, RunFlags(mode="decode",
                                             long_context=dsa_on))
        max_len = -(-max_len // page) * page
    config = ServingConfig(max_len=max_len, long_context=dsa_on,
                           dsa_mode=args.dsa_mode if dsa_on else "off",
                           select_dtype=(args.select_dtype if dsa_on
                                         else "float32"),
                           kv_quant=args.kv_quant,
                           loop=args.loop, slots=args.slots or args.batch,
                           seg_len=args.seg_len,
                           chunk_tokens=args.chunk_tokens, paged=args.paged,
                           pool_pages=args.pool_pages or None)
    if args.continuous:
        return _serve_continuous(cfg, args, params, config, device)
    eng = Engine(cfg, params, config=config, device=device)
    before = launch_counts()
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(1, cfg.vocab - 4,
                           size=(args.batch, args.prompt_len)).astype(np.int32)
    graphs = graph_counts(eng.graphs)
    res = eng.generate(prompts, args.new_tokens)
    captures, replays = (b - a for a, b in zip(graphs,
                                               graph_counts(eng.graphs)))
    row = cache_bytes(init_cache(cfg, 1, max_len, eng.decode_flags,
                                 dtype=eng.cache_dtype, device="meta"))
    print(f"prefill: {res.prefill_s * 1e3:.1f} ms   "
          f"decode: {res.decode_s:.2f} s   "
          f"throughput: {res.tokens_per_s:.1f} tok/s   "
          f"({res.decode_steps} steps in {res.decode_dispatches} "
          f"dispatch{'es' if res.decode_dispatches != 1 else ''}; decode "
          f"graphs: {captures} captured, {replays} replays)")
    after = launch_counts()
    print(f"cache {row} bytes per batch row; launches "
          + " ".join(f"{k} {after[k] - before[k]}" for k in KERNELS))
    print("first new tokens:", res.tokens[:, :8].tolist())
    return res


if __name__ == "__main__":
    main()
