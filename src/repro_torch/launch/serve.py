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

Requests may carry a ``dsa_mode`` of their own on a ``--dsa`` engine
(the synthetic workload's do not); ``--max-mode-wait`` bounds how long
such a request waits for the engine to switch modes:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi_6b \
        --reduced --continuous --paged --dsa --dsa-mode kernel \
        --max-mode-wait 0.5 --requests 6 --slots 2 --prompt-len 64 \
        --new-tokens 8 --device cpu

The request lifecycle: ``--deadline`` gives every request a latency
budget (status ``timeout`` past it), ``--queue-cap`` bounds the admission
queue and ``--shed-policy`` picks whom to shed (status ``shed``); the
run prints the dropped statuses and the SLO attainment.  Telemetry:
``--trace-out`` writes a Chrome trace-event JSON timeline (Perfetto,
chrome://tracing), ``--metrics-out`` a Prometheus text snapshot, and
``--telemetry-sample N`` samples the DSA block selection once per N
segments (each flag turns telemetry on; the sample defaults to 16):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi_6b \
        --reduced --continuous --paged --dsa --dsa-mode kernel \
        --requests 6 --slots 2 --prompt-len 64 --new-tokens 8 \
        --deadline 30 --queue-cap 4 --shed-policy oldest \
        --trace-out /tmp/trace.json --metrics-out /tmp/metrics.prom \
        --telemetry-sample 1 --device cpu

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

``--spec K`` decodes speculatively (repro_torch.inference.speculative):
K tokens a row drafted by n-gram lookup over the row's history, verified
in one forward a round (on ``--dsa-mode kernel`` K1 once per verified
row per layer) and committed, with the plain tokens in f32 (in bf16 at
full width a product over the chunk's rows may round otherwise than the
decode step's and change a token: inference/speculative.py).  Outside the
speculation envelope (RWKV6, a sliding-window ring, K + 1 > 64 on a DSA
path) the static path prints a note and decodes plainly; the continuous
engine turns it off there and on a ``--paged`` cache.  Both lines report
the verify rounds and how many tokens each round emitted:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi_6b \
        --reduced --dsa --dsa-mode kernel --spec 4 --device cpu

``--arch mixtral_8x22b`` serves the mixture-of-experts model (8 experts,
top 2, on a 4096-token sliding-window ring): prefill routes each row's
tokens through the capacity dispatch, decode steps run every expert on
every token; ``--moe-prefill dense`` routes prefill decode-dense too
(token-exact with chunk steps, so an MoE arch without a ring can
chunk-admit).  Its full width does not fit one card at all 56 layers:
``--layers N`` cuts the depth, and ``--cache-dtype bfloat16`` keeps the
residual stream of a bf16 model in bf16 through decode (the default f32
cache promotes it, and each step then copies every expert to f32):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral_8x22b \
        --reduced --batch 2 --prompt-len 96 --new-tokens 8 --dsa \
        --dsa-mode kernel --moe-prefill dense --device cpu

``--arch deepseek_v3`` serves multi-head latent attention over 256
experts (top 8, one shared) after a dense prologue of 3 layers: prefill
expands the latent cache to per-head keys (DSA's block path is the plain
gather: no kernel), decode attends in the latent space.  ``--layers N``
keeps the prologue (3 is the prologue alone, 5 adds two MoE layers); the
cache is 576 values a token a layer; serve it on ``--cache-dtype
bfloat16`` (the absorbed decode on an f32 cache turns the residual
stream f32):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek_v3 \
        --reduced --batch 2 --prompt-len 64 --new-tokens 8 --dsa \
        --dsa-mode block --device cpu

``--arch rwkv6_3b`` serves the RWKV6 model: its prefill runs the chunked
wkv kernel K7 once per layer when the prompt is a multiple of 32 longer
than 32; ``--dsa`` falls back to off (no score matrix), and the cache
line reports the recurrent state's bytes.  ``--continuous`` admits it
blocking (requests of one prompt length share a prefill; the insert
overwrites the slot's state):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6_3b \
        --reduced --batch 2 --prompt-len 64 --new-tokens 8 --device cpu

``--arch jamba_1_5_large`` serves the Mamba hybrid (a group of 8
sub-blocks: Mamba but for one attention sub-block, MoE on every other
one); DSA runs on its attention sub-block (K2 in prefill, K1 in decode),
and ``--continuous`` admits it blocking, as RWKV6.  ``--layers N`` keeps
whole groups or, below 8, one group's first N sub-blocks (5 has every
kind); serve a bf16 model on ``--cache-dtype bfloat16``:

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch jamba_1_5_large --reduced --continuous --dsa \
        --dsa-mode kernel --requests 6 --slots 2 --prompt-len 64 \
        --new-tokens 8 --device cpu

``--tp N`` and ``--dp N`` (or ``--mesh``, data parallelism over every
process) serve on a mesh of processes, one a device, each running this
same command (repro_torch.launch.mesh): under ``torchrun``, which sets
RANK / WORLD_SIZE / LOCAL_RANK, or with ``--nodes``, ``--node-id`` and
``--coordinator`` per process.  Rank 0 prints the ``serving mesh:`` line
and the results; every rank exits non-zero if any rank fails.  The
engine draws the weights piece by piece and keeps this rank's shard of
each, so a card holds its shard and one piece whole, never the whole
model.  On two cards:

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
        --arch yi_6b --tp 2 --batch 4 --prompt-len 4096 --new-tokens 64 \
        --dsa --dsa-mode kernel

NCCL is the default backend; ``--backend gloo`` is what the CPU takes
(``--device cpu``), and what two processes sharing one card take.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import io
import os
import tempfile

import numpy as np

import torch
import torch.distributed as dist

from repro_torch.configs.base import cut_layers, get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.inference.config import ServingConfig
from repro_torch.inference.engine import Engine
from repro_torch.inference.scheduler import (ContinuousEngine, summarize,
                                             synthetic_workload)
from repro_torch.inference.speculative import can_speculate
from repro_torch.inference.telemetry import Telemetry
from repro_torch.kernels.dsa_attention import dsa_block_sparse_attention
from repro_torch.kernels.dsa_chunk_prefill import (
    dsa_chunk_gather_attention, dsa_chunk_paged_gather_attention)
from repro_torch.kernels.dsa_decode import (dsa_decode_gather_attention,
                                            dsa_decode_paged_gather_attention)
from repro_torch.kernels.wkv6 import wkv6_chunked
from repro_torch.launch.mesh import init_serving_processes, make_serving_mesh
from repro_torch.models.attention import RunFlags, cache_page_size
from repro_torch.models.transformer import init_cache, init_model

# seconds a collective waits for a peer before the rank fails
PEER_TIMEOUT_S = 600.0

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


def _print_tp(eng) -> None:
    """Under tensor parallelism, the weight bytes on each device."""
    if eng.mesh is not None and eng.tp > 1:
        print(f"tensor parallel: tp={eng.tp}, "
              f"{eng.weight_bytes_per_device() / 2**20:.2f} MiB "
              f"weights/device")


def draw_extras(cfg, batch: int, rng) -> dict:
    """The stub frontends' input for ``batch`` rows, standard normal from
    ``rng`` (numpy, f32): whisper's ``enc_x`` (``enc_seq_len`` frame
    embeddings), llama vision's ``img`` (``n_image_tokens`` patch
    embeddings); empty for an arch with neither.  ``main`` draws it after
    the prompts, as the reference does."""
    extras = {}
    if cfg.enc_dec:
        extras["enc_x"] = rng.normal(
            size=(batch, cfg.enc_seq_len, cfg.d_model)).astype(np.float32)
    if cfg.cross_attn_period:
        extras["img"] = rng.normal(
            size=(batch, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return extras


def _serve_continuous(cfg, args, eng, device):
    """Serve the synthetic workload on ``eng``; returns (results,
    engine)."""
    _print_tp(eng.engine)
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
    # an all-shed or all-failed run completes no request: the wall clock
    # defaults to 0 and the lifecycle line still says what happened
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
          f"{cache_bytes(eng._caches) // (eng._hi - eng._lo)} bytes per "
          f"slot")
    if args.spec:
        st = eng.stats
        print(f"speculative: K {eng.spec}" + (
            "" if eng.spec else " (off: paged cache or outside "
            "speculative.can_speculate)")
            + f", {st['spec_rounds']} verify rounds, {st['spec_emitted']} "
            f"tokens, accept hist {st['accept_hist']}, drafting "
            f"{st['draft_s']:.3f} s, proposer failures "
            f"{st['proposer_failures']}")
    dropped = [f"{s[k]} {k[2:]}" for k in ("n_timeout", "n_cancelled",
                                           "n_failed", "n_shed") if s[k]]
    if dropped or args.deadline is not None or not s["n_ok"]:
        slo = (f", SLO attainment {s['slo_attainment']:.0%}"
               if args.deadline is not None else "")
        print(f"lifecycle : {s['n_ok']} ok"
              + "".join(f", {d}" for d in dropped) + slo)
    tel = eng.telemetry
    if tel is not None:
        if args.trace_out:
            tel.write_chrome_trace(args.trace_out)
            print(f"telemetry : {len(tel.events)} trace events -> "
                  f"{args.trace_out} (load in Perfetto / chrome://tracing)")
        if args.metrics_out:
            tel.write_prometheus(args.metrics_out)
            print(f"telemetry : Prometheus snapshot -> {args.metrics_out}")
        progs = sorted({p for p, _, _ in tel.compiles})
        print("compiles  : " + ", ".join(
            f"{p}={tel.compile_count(p)}" for p in progs))
        kr = tel.metrics.value("serving_dsa_keep_rate")
        if isinstance(kr, tuple) and kr[0]:   # plain 0.0: no probe ran
            print(f"sparsity  : {kr[0]} DSA selection samples, "
                  f"mean keep-rate {kr[1]:.2f} "
                  f"({eng.stats['probe_steps']} probe steps, "
                  f"{eng.stats['probe_s'] * 1e3:.1f} ms)")
    return results, eng


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--new-tokens", type=int, default=64)
    ap.add_argument("--max-len", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the arch to its first N layers (0 = all)")
    ap.add_argument("--cache-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="K/V cache dtype (full-precision caches)")
    ap.add_argument("--moe-prefill", default="capacity",
                    choices=["capacity", "dense"],
                    help="MoE prefill: capacity dispatch | decode-dense "
                         "(token-exact with chunk steps)")
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
    ap.add_argument("--spec", type=int, default=0,
                    help="speculative decoding: K draft tokens verified "
                         "per forward (0 = off; the plain tokens in f32)")
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
    ap.add_argument("--max-mode-wait", type=float, default=None,
                    help="seconds a queued other-dsa_mode request may "
                         "wait before forcing a drain and mode switch "
                         "(--continuous; default: wait for an idle drain)")
    ap.add_argument("--kv-quant", default=None, choices=["int8", "fp8"],
                    help="quantized K/V cache storage dtype with per-row "
                         "scales, dequantized on gather (default: off)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request latency budget in seconds "
                         "(--continuous): requests retire with status "
                         "'timeout' past it (default: no deadlines)")
    ap.add_argument("--queue-cap", type=int, default=0,
                    help="bounded admission queue for --continuous "
                         "(0 = unbounded); overflow sheds per "
                         "--shed-policy with status 'shed'")
    ap.add_argument("--shed-policy", default="reject",
                    choices=["reject", "oldest", "lowest-priority"],
                    help="whom to shed when the queue is at --queue-cap")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace-event JSON timeline of the "
                         "--continuous run here (enables telemetry)")
    ap.add_argument("--metrics-out", default=None,
                    help="write a Prometheus text-format metrics snapshot "
                         "of the --continuous run here (enables telemetry)")
    ap.add_argument("--telemetry-sample", type=int, default=0,
                    help="sample the DSA block selection once per N decode "
                         "segments (> 0 enables telemetry; default 0 = "
                         "off, or 16 when another telemetry flag is on)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", action="store_true",
                    help="serve on a data-parallel mesh of every process "
                         "(the slots / batch rows shard over 'data')")
    ap.add_argument("--dp", type=int, default=0,
                    help="data-parallel ranks of the mesh (0 = all, or "
                         "all / --tp)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks: a (data, model) mesh "
                         "sharding weights and KV heads over 'model'")
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
    args = ap.parse_args(argv)

    env = os.environ
    if "WORLD_SIZE" in env and "RANK" in env:        # launched by torchrun
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        local = int(env.get("LOCAL_RANK", 0))
        url = "env://"
    else:
        world, rank, local = args.nodes, args.node_id, None
        url = args.coordinator
    if not (args.mesh or args.dp or args.tp > 1 or world > 1):
        return _serve(args, None)
    backend = args.backend
    if backend is None:
        if args.device not in (None, "cuda") and not str(
                args.device).startswith("cuda"):
            raise SystemExit("a mesh on the CPU needs --backend gloo")
        backend = "nccl"
    if world == 1 and "://" not in url:
        # one process: its own rendezvous file, no TCP port
        url = "file://" + os.path.join(tempfile.mkdtemp(), "store")
    init_serving_processes(url, world, rank, local, backend=backend,
                           timeout_s=PEER_TIMEOUT_S)
    try:
        # rank 0 prints; the others serve silently
        quiet = (contextlib.nullcontext() if rank == 0
                 else contextlib.redirect_stdout(io.StringIO()))
        with quiet:
            res = _serve(args, dict(backend=backend, world=world))
        # every rank waits here: one that failed earlier never arrives,
        # and the others' collective fails instead of returning 0
        dist.barrier()
        return res
    finally:
        dist.destroy_process_group()


def _serve(args, group):
    """The run of ``main``; ``group`` is None without a mesh, else the
    process group's backend and world size."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.layers:
        cfg = cut_layers(cfg, args.layers)
    # the engine draws the weights itself, piece by piece, and under
    # tensor parallelism keeps only this rank's shard of each on the card
    params = functools.partial(init_model, args.seed, cfg, device=device)
    max_len = args.max_len or (args.prompt_len + args.new_tokens + 16)
    dsa_on = args.dsa and cfg.dsa.enabled
    if args.paged:
        page = cache_page_size(cfg, RunFlags(mode="decode",
                                             long_context=dsa_on))
        max_len = -(-max_len // page) * page
    mesh = None
    if group is not None:
        mesh = make_serving_mesh(args.dp, tp=args.tp, cfg=cfg)
        sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
        print(f"serving mesh: {sizes} over {group['world']} "
              f"{'devices' if device.type == 'cuda' else 'processes'} "
              f"({group['backend']})")
    tel = None
    if args.trace_out or args.metrics_out or args.telemetry_sample:
        tel = Telemetry(sample_every=args.telemetry_sample or 16)
    config = ServingConfig(max_len=max_len, long_context=dsa_on, mesh=mesh,
                           dsa_mode=args.dsa_mode if dsa_on else "off",
                           select_dtype=(args.select_dtype if dsa_on
                                         else "float32"),
                           kv_quant=args.kv_quant,
                           cache_dtype=getattr(torch, args.cache_dtype),
                           moe_prefill=args.moe_prefill,
                           loop=args.loop, slots=args.slots or args.batch,
                           seg_len=args.seg_len,
                           chunk_tokens=args.chunk_tokens, paged=args.paged,
                           pool_pages=args.pool_pages or None,
                           max_mode_wait_s=args.max_mode_wait,
                           spec=args.spec, deadline_s=args.deadline,
                           queue_cap=args.queue_cap or None,
                           shed_policy=args.shed_policy, telemetry=tel)
    if args.continuous:
        eng = ContinuousEngine(cfg, params, config=config, device=device)
        return _serve_continuous(cfg, args, eng, device)
    eng = Engine(cfg, params, config=config, device=device)
    _print_tp(eng)
    before = launch_counts()
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(1, cfg.vocab - 4,
                           size=(args.batch, args.prompt_len)).astype(np.int32)
    extras = draw_extras(cfg, args.batch, rng)
    spec = args.spec
    if spec and not can_speculate(cfg, eng.decode_flags.dsa_mode, spec):
        print(f"note: spec={spec} is outside the speculation envelope for "
              f"{cfg.name}; decoding plainly")
        spec = 0
    graphs = graph_counts(eng.graphs)
    res = eng.generate(prompts, args.new_tokens, spec=spec,
                       extras=extras or None)
    captures, replays = (b - a for a, b in zip(graphs,
                                               graph_counts(eng.graphs)))
    row = cache_bytes(init_cache(eng.mcfg, 1, max_len, eng.decode_flags,
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
    if res.spec_rounds:
        print(f"speculative: {res.spec_rounds} verify rounds, accept hist "
              f"{res.spec_accept_hist}, {res.delivered_tokens} tokens "
              f"delivered -> {res.tokens_per_s:.1f} tok/s")
    print("first new tokens:", res.tokens[:, :8].tolist())
    return res


if __name__ == "__main__":
    main()
