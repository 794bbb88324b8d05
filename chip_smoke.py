#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (exit code 1, no result line) if it
fails:

  1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
  2. build: nvcc compiles every kernel source of the checkout, in parallel;
     ptxas must report no register spill in any instance of any of them
     (dsa_decode.cu, dsa_attention.cu, dsa_chunk_prefill.cu, wkv6.cu);
  3. kernels: K1 (decode gather-attend), K2 (block-sparse prefill), K3
     (chunk prefill) and K4 (paged decode) against their plain PyTorch
     versions on the same inputs, at a reduced geometry (hd 16, block 16,
     f32; K2 also bf16) and at yi_6b's full geometry (K1/K4 bf16 q against
     a bf16 and the default f32 cache, and f32; K2 bf16 and f32, and bf16
     at stablelm_3b's width, hd 80 with 32 KV heads, and on its
     sliding-window path at h2o_danube_1_8b's reduced geometry (window 64
     at block 16, f32 and bf16), its f32 parity run's and its prefill's
     (B 4, L 8192, hd 80, G 4, window 4096, 6 blocks kept, bf16, timed);
     K3 every dtype pair;
     K4 also at the continuous slice's shape: 64 logical
     blocks, a 257-page pool, 9 blocks selected), each within a stated
     atol + rtol, with times (CUDA events, L2 flushed before each launch),
     host enqueue time, the plain versions' and one PyTorch library
     call's times, and the least time the card could take; K4 must also
     equal K1 bit for bit on a pool that holds K1's cache under a
     shuffled page table.  The quantized bodies K1q, K4q and K3q on int8
     and fp8 caches at the reduced geometry and at the main path's shapes
     (bf16 q), each also bit for bit equal to its unquantized kernel on
     the dequantized cache; K5 and K5q (the paged chunk kernel, no model
     path) bit for bit equal to K3 and K3q on a shuffled pool; times as
     above, the bound counted from the narrow bytes;
  4. parity: yi_6b at full width with 2 layers in f32 serves the same
     greedy tokens with dsa_mode="kernel" as with the plain "block" path,
     and four requests get the same greedy tokens from the continuous
     engine (paged cache, kernel path), the continuous engine (dense
     cache, block path) and the static engine; the page pool returns full.
     With int8 K/V and int8 selection the two chunked continuous engines
     agree, and the static engine agrees with the paged kernel engine
     under blocking admission (chunked admission attends a chunk's own
     rows quantized, whole-prompt prefill in full precision).  Graphed
     decode against eager decode, bit for bit: the static engine's scan
     loop (a CUDA graph replay a step) against its python loop (eager
     steps), f32 and fp8 K/V, and the paged continuous engine's segments
     (replays of the masked step's graph) against each request's solo
     python-loop generate, greedy and sampled, f32 and int8 K/V (int8
     under blocking admission), with one capture per engine;
  5. the static slice: ``repro_torch.launch.serve`` serves yi_6b at full
     width, all 32 layers in bf16, random weights from --seed, batch 4,
     prompt 4096, 64 new tokens, DSA on the kernel path; the launch
     counters show K2 ran once per layer in prefill and K1 once per layer
     per decode step (each step one replay of the step's CUDA graph, whose
     replays add the launches the capture recorded);
  6. the continuous slice: ``repro_torch.launch.serve --continuous
     --paged`` serves 8 synthetic requests (prompts 1024-4096, 16-64 new
     tokens, all queued at the start) on the same model through 4 slots of
     a paged cache of max_len 8192, chunked admission 512 tokens wide and
     segments of 16 steps; every request must finish ok, K3 must launch
     once per layer per chunk step and K4 once per layer per decode step,
     and the segments must have captured one graph and replayed it once a
     decode step; then a torch.profiler trace of one chunk step and one
     segment;
  7. the quantized slices: phase 5 with an fp8 K/V cache and int8
     selection and 32 new tokens (K1q once per layer per decode step, K1
     never), and phase 6 with int8 K/V and int8 selection (K3q and K4q in
     place of K3 and K4, which must not launch), with the pool's bytes per
     slot and the same profile;
  8. profile: a torch.profiler trace of one prefill and a few decode steps
     of the static slice (wall time, device busy share, top kernels), the
     steps replays of the captured step, with the capture's time and the
     bytes its graph pool reserved;
  9. RWKV6: K7 (chunked wkv6) against its plain version at the reduced
     geometry (B 2, H 4, S 128, hd 16, f32) and at rwkv6_3b's (B 4, H 40,
     S 4096, hd 64, bf16 and f32), each from a zero and a random state,
     y at the dtype's tolerance and s_last at f32's, and in the clamp case
     (w = 0.3: the -30 clamp binds in every chunk) in f32 and bf16, timed
     as above at the main path's case; a 2-layer
     full-width rwkv6_3b in f32 serves the same greedy tokens on the card
     (K7) as on the CPU (the plain version), prompt 512, 16 new, and the
     card's graphed scan loop the same tokens as its eager python loop; the
     rwkv6_3b slice, ``repro_torch.launch.serve --arch rwkv6_3b`` at full
     width, 32 layers in bf16, batch 4, prompt 4096, 64 new tokens: K7
     exactly once per layer in prefill and no attention kernel; a
     torch.profiler trace of its prefill and decode steps; and one timed
     prefill of 4 x 4095 tokens, a length that takes the token scan and
     not K7;
 10. faithful DSA (the paper's token granularity, no kernel): a 2-layer
     full-width yi_6b in f32 serves the same greedy tokens on the card as
     on the CPU, full precision and with fp8 K/V and int8 selection; the
     graphed scan loop equals the eager one and the paged continuous
     engine's segments equal solo eager generates, bit for bit; then the
     full-width slice (32 layers, bf16, batch 4, prompt 4096, 64 new
     tokens) with no kernel launched, and its profile;
 11. sliding window: a 2-layer full-width h2o_danube_1_8b in f32 on
     prompts of 4352 tokens (the 4096-row ring wraps at prefill and in
     decode): DSA off card == CPU, kernel (K2 with the window) == block,
     graphed == eager; then the full-width slice (24 layers, bf16, batch
     4, prompt 8192, 64 new tokens, DSA kernel path): K2 once per layer
     in prefill, no decode kernel, the ring's bytes per batch row, and
     its profile;
 12. training (the paper's joint objective, Eq. 7, with AdamW; the plain
     model path, no kernel): a 2-layer full-width stablelm_3b in f32 with
     remat takes one step (batch 2 x 512, 2 microbatches) on the card and
     on the CPU from the same params: loss, ce, mse and grad_norm agree,
     the new params agree within the first AdamW step's sign bound, P is
     unchanged and no kernel launches; the eval step on the kernel path
     (K2 once a layer) gives the block path's ce; then
     ``repro_torch.launch.train`` trains stablelm_3b at full width (32
     layers, bf16, remat, 4 steps of 4 x 4096 in 2 microbatches): finite
     metrics, P unchanged, no kernel launched, the median step time,
     tokens/s, the 6 N D share of 989 TFLOP/s, peak memory and the bytes
     of params, grads and moments; and a torch.profiler trace of one more
     step and of the optimizer update alone.

It then prints one JSON line of per-kernel results, the card's name and
power limit again as ``nvidia-smi`` gives them, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a card, or outside a checkout of the repository, it exits with 1
and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# (atol, rtol) of a kernel against its plain version on the same inputs:
# |got - want| <= atol + rtol * |want| everywhere.  Both compute in f32; in
# bf16 both round their f32 result once, and one bf16 step is at most 2^-7
# (7.8e-3) of the value, so rtol 1e-2 holds one step; atol covers f32
# summation order on outputs near zero.
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-4, 1e-2)}
# sources whose every instance must build without a register spill
NO_SPILL = ("dsa_decode", "dsa_attention", "dsa_chunk_prefill", "wkv6")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def compare(torch, got, want, dtype: str) -> dict:
    """Max abs error of ``got`` against ``want`` and the largest share of
    the tolerance any element uses (> 1 fails)."""
    atol, rtol = TOL[dtype]
    d = (got.float() - want.float()).abs()
    used = float((d / (atol + rtol * want.float().abs())).max())
    ok = used <= 1.0 and bool(torch.isfinite(got).all())
    return dict(max_abs_err=float(d.max()), tol_used=used,
                tol=[atol, rtol], ok=ok)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Mean device time of a call, with the 50 MB L2 flushed before each
    launch (the main path finds these operands cold).  The queue is held
    behind a spinning kernel while the host enqueues every iteration, so
    the events bracket device work and not the host's launch latency."""

    def __init__(self, torch):
        self.torch = torch
        self.scrub = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters: int, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        evs = [(torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        torch.cuda._sleep(int(2e9 * (0.02 + 0.002 * iters)))  # ~cycles
        for s, e in evs:
            self.scrub.zero_()
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in evs) / iters

    def host_us(self, fn, iters: int = 200) -> float:
        """Host time to enqueue one call (no synchronisation inside)."""
        torch = self.torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / iters * 1e6


def quantize(torch, kc, vc, quant):
    """The narrow cache of a check: (k, v, {k_scale, v_scale}) quantized
    as ``quant`` ("int8" | "fp8"), or the cache itself for None."""
    if quant is None:
        return kc, vc, {}
    from repro_torch.core.quantization import quant_store
    (kq, ks), (vq, vs) = (quant_store(t, dtype=quant) for t in (kc, vc))
    return kq, vq, dict(k_scale=ks, v_scale=vs)


def dequantized(torch, kc, vc, sc):
    """The f32 cache a narrow one stands for (the cache itself if full
    width)."""
    if not sc:
        return kc, vc
    from repro_torch.core.quantization import dequant
    return dequant(kc, sc["k_scale"]), dequant(vc, sc["v_scale"])


def cache_bytes_per_row(kc, sc) -> int:
    """Bytes one (row, KV head) of K or V takes: hd narrow or full-width
    elements plus, narrow, its f32 scale."""
    return kc.shape[-1] * kc.element_size() + (4 if sc else 0)


def equal_unquantized(torch, res, name, got, unq) -> None:
    """Hold a quantized kernel bit for bit to its unquantized kernel on
    the dequantized cache."""
    res["equal_unquantized"] = bool(torch.equal(got, unq))
    if not res["equal_unquantized"]:
        fail(f"{name} is not bitwise equal to its unquantized kernel on the "
             f"dequantized cache: {res}")


def bound(bytes_moved: float, flops: float, dtype: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- K1 -------------------------------------------------------------------------


def check_k1(torch, timer, *, b, hq, hkv, hd, s, bk, q_dt, c_dt, kv_len,
             nb, seed, timed, quant=None):
    """K1 (K1q with ``quant``: the cache drawn in c_dt, then stored
    narrow) against its plain version; K1q also bit for bit against K1
    on the dequantized cache."""
    from repro_torch.core.masks import decode_block_topk_indices
    from repro_torch.kernels import dsa_decode as K1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def rnd(*shape, d):
        return torch.randn(shape, generator=gen, device=dev).to(dt[d])

    q = rnd(b, hq, 1, hd, d=q_dt)
    kc, vc, sc = quantize(torch, rnd(b, s, hkv, hd, d=c_dt),
                          rnd(b, s, hkv, hd, d=c_dt), quant)
    kvl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    n_kb = -(-s // bk)
    scores = torch.randn((b, n_kb), generator=gen, device=dev)
    idx, ok = decode_block_topk_indices(scores, min(nb, n_kb), kv_len=kvl,
                                        block_k=bk)
    args = (q, kc, vc, idx, ok, kvl)
    kw = dict(block_k=bk, **sc)
    got = K1.dsa_decode_gather_attention(*args, **kw)
    want = K1.dsa_decode_gather_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    kd, vd = dequantized(torch, kc, vc, sc)
    name = "K1q" if quant else "K1"
    res = dict(geometry=f"B{b} Hq{hq} Hkv{hkv} hd{hd} S{s} bk{bk} nb{nb} "
                        f"q {q_dt} cache {quant or c_dt}",
               **compare(torch, got, want, q_dt))
    if not res["ok"]:
        fail(f"{name} disagrees with its plain version: {res}")
    if quant:
        equal_unquantized(torch, res, name, got, K1.dsa_decode_gather_attention(
            q, kd, vd, idx, ok, kvl, block_k=bk))
    if not timed:
        return res
    # bytes this call needs: q, the live selected K/V rows, out, indices
    kpos = idx.long()[:, :, None] * bk + torch.arange(bk, device=dev)
    live = (kpos < kvl[:, None, None]) & ok[:, :, None] & (kpos < s)
    rows = int(live.sum())
    q_el = q.element_size()
    nbytes = (2 * q.numel() * q_el + 2 * rows * hkv * cache_bytes_per_row(
        kc, sc) + 2 * idx.numel() * 4 + kvl.numel() * 4)
    flops = 4.0 * rows * (hq // hkv) * hkv * hd
    work_dt = ("bfloat16" if q_dt == c_dt == "bfloat16" and not quant
               else "float32")
    res["bound_ms"], res["bound_by"] = bound(nbytes, flops, work_dt)
    res["ms"] = timer(lambda: K1.dsa_decode_gather_attention(
        *args, **kw), iters=50)
    res["host_us"] = timer.host_us(lambda: K1.dsa_decode_gather_attention(
        *args, **kw))
    res["plain_ms"] = timer(lambda: K1.dsa_decode_gather_attention_plain(
        *args, **kw), iters=10)
    # library yardstick: one SDPA call over the whole (dequantized) cache
    # with the selected rows as its mask (layouts prepared outside the
    # timing)
    g = hq // hkv
    lib_dt = torch.float32 if work_dt == "float32" else torch.bfloat16
    kk = kd.transpose(1, 2).repeat_interleave(g, 1).to(lib_dt)
    vv = vd.transpose(1, 2).repeat_interleave(g, 1).to(lib_dt)
    qq = q.to(lib_dt)
    rowmask = torch.zeros((b, s), dtype=torch.bool, device=dev)
    bidx = torch.arange(b, device=dev)[:, None, None].expand_as(kpos)
    rowmask[bidx[live], kpos[live]] = True
    mask = rowmask[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_err = float((sdpa(qq, kk, vv, attn_mask=mask).float()
                     - want.float()).abs().max())
    res["library_ms"] = timer(lambda: sdpa(qq, kk, vv, attn_mask=mask),
                              iters=20)
    res["library_max_abs_err"] = lib_err
    return res


# -- K2 -------------------------------------------------------------------------


def check_k2(torch, timer, *, b, hq, hkv, hd, l, blk, nb, dtype, seed,
             timed, window=0):
    """K2 against its plain version on the model's selection (with
    ``window``: the sliding-window selection and mask of an SWA arch)."""
    from repro_torch.core.masks import block_topk_indices
    from repro_torch.kernels import dsa_attention as K2
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(td)

    q, k, v = rnd(b, hq, l, hd), rnd(b, hkv, l, hd), rnd(b, hkv, l, hd)
    n = l // blk
    idx, ok = block_topk_indices(
        torch.randn((b, n, n), generator=gen, device=dev), nb,
        window_blocks=window // blk)
    kw = dict(block_q=blk, block_k=blk, causal=True, window=window)
    got = K2.dsa_block_sparse_attention(q, k, v, idx, ok, **kw)
    want = K2.dsa_block_sparse_attention_plain(q, k, v, idx, ok, **kw)
    torch.cuda.synchronize()
    res = dict(geometry=f"B{b} Hq{hq} Hkv{hkv} hd{hd} L{l} block{blk} "
                        f"nb{nb}{f' window{window}' if window else ''} "
                        f"{dtype}",
               **compare(torch, got, want, dtype))
    if not res["ok"]:
        fail(f"K2 disagrees with its plain version: {res}")
    if not timed:
        return res
    # the work this call's selection needs: the live (query, key) pairs of
    # the valid visited blocks, causal and inside the window; the distinct
    # K/V blocks holding a live pair, read once
    kb = idx.long()
    qpos = torch.arange(l, device=dev).reshape(1, n, 1, blk)
    k_lo = kb[..., None] * blk                            # (B, nQb, nb, 1)
    lo = torch.maximum(k_lo, qpos - window + 1) if window else k_lo
    hi = torch.minimum(k_lo + blk - 1, qpos)
    per = ((hi - lo + 1).clamp(min=0) * ok[..., None]).sum(-1)  # (B,nQb,nb)
    pairs = int(per.sum())
    live = per > 0
    used = torch.zeros((b, n), dtype=torch.bool, device=dev)
    used[torch.arange(b, device=dev)[:, None, None].expand_as(kb)[live],
         kb[live]] = True
    el = q.element_size()
    nbytes = (2 * q.numel() * el + 2 * int(used.sum()) * hkv * blk * hd * el
              + 2 * idx.numel() * 4)
    flops = 4.0 * pairs * hq * hd
    res["bound_ms"], res["bound_by"] = bound(nbytes, flops, dtype)
    res["ms"] = timer(lambda: K2.dsa_block_sparse_attention(
        q, k, v, idx, ok, **kw), iters=5)
    res["host_us"] = timer.host_us(lambda: K2.dsa_block_sparse_attention(
        q, k, v, idx, ok, **kw), iters=20)
    res["plain_ms"] = timer(lambda: K2.dsa_block_sparse_attention_plain(
        q, k, v, idx, ok, **kw), iters=2, warmup=1)
    # library yardstick: one SDPA call with the expanded block mask
    g = hq // hkv
    kk, vv = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    bmask = (torch.nn.functional.one_hot(kb, n).bool()
             & ok[..., None]).any(dim=-2)
    tmask = bmask.repeat_interleave(blk, 1).repeat_interleave(blk, 2)
    tmask &= torch.ones((l, l), dtype=torch.bool, device=dev).tril()
    if window:
        tmask &= ~torch.ones((l, l), dtype=torch.bool,
                             device=dev).tril(-window)
    mask = tmask[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res["library_max_abs_err"] = float(
        (sdpa(q, kk, vv, attn_mask=mask).float() - want.float()).abs().max())
    res["library_ms"] = timer(lambda: sdpa(q, kk, vv, attn_mask=mask),
                              iters=3, warmup=1)
    del tmask, mask, kk, vv
    return res


# -- K3 -------------------------------------------------------------------------


def check_k3(torch, timer, *, b, hq, hkv, hd, s, c, blk, q_dt, c_dt, q_off,
             chunk_len, seed, timed, quant=None, paged=False):
    """K3 on a chunk of C queries at per-row offsets q_off over an S-row
    cache, rows ragged by chunk_len; the selection is the chunk path's:
    chunk_block_topk_indices of random block scores, keeping yi_6b's
    nb_keep at sparsity 0.9.  ``quant`` stores the cache narrow (K3q,
    held bit for bit to K3 on the dequantized cache); ``paged`` runs K5
    (K5q) on a pool that holds the cache under a shuffled page table,
    held bit for bit to K3 (K3q) on the dense cache."""
    from repro_torch.core.masks import chunk_block_topk_indices, keep_count
    from repro_torch.core.quantization import raw
    from repro_torch.kernels import dsa_chunk_prefill as K3
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def rnd(*shape, d):
        return torch.randn(shape, generator=gen, device=dev).to(dt[d])

    q = rnd(b, hq, c, hd, d=q_dt)
    kc, vc, sc = quantize(torch, rnd(b, s, hkv, hd, d=c_dt),
                          rnd(b, s, hkv, hd, d=c_dt), quant)
    qo = torch.tensor(q_off, dtype=torch.int32, device=dev)
    kvl = qo + torch.tensor(chunk_len, dtype=torch.int32, device=dev)
    n_kb, n_qb = -(-s // blk), c // blk
    nb = min(n_kb, max(2, keep_count(n_kb, 0.9)))
    scores = torch.randn((b, n_qb, n_kb), generator=gen, device=dev)
    idx, ok = chunk_block_topk_indices(scores, nb, q_block_offset=qo // blk)
    dense_args = (q, kc, vc, idx, ok, qo, kvl)
    kw = dict(block_q=blk, block_k=blk, **sc)
    geometry = (f"B{b} Hq{hq} Hkv{hkv} hd{hd} C{c} S{s} block{blk} nb{nb} "
                f"q {q_dt} cache {quant or c_dt}")
    if paged:
        n_pages = b * n_kb + 3
        perm = torch.randperm(
            n_pages - 1, generator=torch.Generator().manual_seed(seed)) + 1
        tbl = perm[:b * n_kb].reshape(b, n_kb).to(dev)
        rows = (tbl[:, :, None] * blk + torch.arange(blk, device=dev)
                ).reshape(b, n_kb * blk)
        pools = []
        for t in (kc, vc, *sc.values()):
            pool = torch.zeros((n_pages * blk,) + tuple(t.shape[2:]),
                               dtype=t.dtype, device=dev)
            raw(pool)[rows] = raw(t)
            pools.append(pool)
        pidx = torch.gather(tbl[:, None, :].expand(b, n_qb, n_kb), 2,
                            idx.long()).to(torch.int32)
        args = (q, pools[0], pools[1], idx, pidx, ok, qo, kvl)
        call_kw = dict(block_q=blk, block_k=blk,
                       **dict(zip(("k_scale", "v_scale"), pools[2:])))
        fn = K3.dsa_chunk_paged_gather_attention
        plain = K3.dsa_chunk_paged_gather_attention_plain
        geometry += f" pages{n_pages}"
    else:
        args, call_kw = dense_args, kw
        fn = K3.dsa_chunk_gather_attention
        plain = K3.dsa_chunk_gather_attention_plain
    got = fn(*args, **call_kw)
    want = plain(*args, **call_kw)
    torch.cuda.synchronize()
    kd, vd = dequantized(torch, kc, vc, sc)
    name = ("K5" if paged else "K3") + ("q" if quant else "")
    res = dict(geometry=geometry, **compare(torch, got, want, q_dt))
    if not res["ok"]:
        fail(f"{name} disagrees with its plain version: {res}")
    if quant:
        equal_unquantized(torch, res, name, got, K3.dsa_chunk_gather_attention(
            q, kd, vd, idx, ok, qo, kvl, block_q=blk, block_k=blk))
    if paged:
        dense = K3.dsa_chunk_gather_attention(*dense_args, **kw)
        res["equal_k3"] = bool(torch.equal(got, dense))
        if not res["equal_k3"]:
            fail(f"{name} is not bitwise equal to K3 on the same rows: {res}")
    if not timed:
        return res
    # the work this call's selection needs: live (query, key) pairs, and
    # the live selected K/V rows read once
    ar = torch.arange(blk, device=dev)
    kpos = idx.long()[..., None] * blk + ar                 # (B,nQb,nb,Bk)
    qpos = (qo.long()[:, None, None]
            + (torch.arange(n_qb, device=dev)[:, None] * blk + ar)[None])
    live_k = (ok[..., None] & (kpos < kvl.long()[:, None, None, None])
              & (kpos < s))
    pair = (live_k[:, :, None]
            & (kpos[:, :, None] <= qpos[:, :, :, None, None]))
    pairs = int(pair.sum())                 # per (row, query, key)
    used = torch.zeros((b, n_kb * blk), dtype=torch.bool, device=dev)
    bidx = torch.arange(b, device=dev)[:, None, None, None].expand_as(kpos)
    used[bidx[live_k], kpos[live_k]] = True
    rows = int(used.sum())
    q_el = q.element_size()
    nbytes = (2 * q.numel() * q_el + 2 * rows * hkv * cache_bytes_per_row(
        kc, sc) + (3 if paged else 2) * idx.numel() * 4 + 2 * b * 4)
    flops = 4.0 * pairs * hq * hd
    work_dt = ("bfloat16" if q_dt == c_dt == "bfloat16" and not quant
               else "float32")
    res["bound_ms"], res["bound_by"] = bound(nbytes, flops, work_dt)
    res["ms"] = timer(lambda: fn(*args, **call_kw), iters=20)
    res["host_us"] = timer.host_us(lambda: fn(*args, **call_kw), iters=50)
    res["plain_ms"] = timer(lambda: plain(*args, **call_kw), iters=3,
                            warmup=1)
    # library yardstick: one SDPA call over the whole (dequantized) cache
    # with the selection, the causal limit and kv_len as a boolean mask
    g = hq // hkv
    lib_dt = dt[work_dt]
    kk = kd.transpose(1, 2).repeat_interleave(g, 1).to(lib_dt)
    vv = vd.transpose(1, 2).repeat_interleave(g, 1).to(lib_dt)
    qq = q.to(lib_dt)
    bm = (torch.nn.functional.one_hot(idx.long(), n_kb).bool()
          & ok[..., None]).any(dim=-2)                     # (B, nQb, nKb)
    tm = bm.repeat_interleave(blk, 1).repeat_interleave(blk, 2)[:, :, :s]
    kj = torch.arange(s, device=dev)
    tm = tm & (kj <= qpos.reshape(b, c)[..., None]) & (kj < kvl[:, None, None])
    mask = tm[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    live_q = tm.any(-1)                     # rows with no live key give NaN
    lib = sdpa(qq, kk, vv, attn_mask=mask).float().transpose(1, 2)
    res["library_max_abs_err"] = float(
        (lib - want.float().transpose(1, 2))[live_q].abs().max())
    res["library_ms"] = timer(lambda: sdpa(qq, kk, vv, attn_mask=mask),
                              iters=5, warmup=1)
    del kk, vv, mask, tm, lib
    return res


# -- K4 -------------------------------------------------------------------------


def check_k4(torch, timer, *, b, hq, hkv, hd, s, bk, q_dt, c_dt, kv_len,
             nb, seed, timed, pages=None, quant=None):
    """K4 on a pool of ``pages`` pages (default: every block of the B
    rows plus the zero page and 2 spare) under a shuffled page table that
    maps each row's blocks up to its kv_len, as the paged cache does, and
    leaves the rest on the zero page; the pool's other rows hold random
    values.  Against its plain version, and bit for bit against K1 on the
    dense cache the table describes.  ``quant`` stores the pool narrow
    (K4q, also held bit for bit to K4 on the dequantized pool)."""
    from repro_torch.core.masks import decode_block_topk_indices
    from repro_torch.core.quantization import take
    from repro_torch.kernels import dsa_decode as K
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def rnd(*shape, d):
        return torch.randn(shape, generator=gen, device=dev).to(dt[d])

    q = rnd(b, hq, 1, hd, d=q_dt)
    kvl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    n_kb = -(-s // bk)
    scores = torch.randn((b, n_kb), generator=gen, device=dev)
    idx, ok = decode_block_topk_indices(scores, min(nb, n_kb), kv_len=kvl,
                                        block_k=bk)
    n_pages = pages or b * n_kb + 3
    used = [-(-n // bk) for n in kv_len]
    perm = torch.randperm(n_pages - 1,
                          generator=torch.Generator().manual_seed(seed)) + 1
    tbl = torch.zeros((b, n_kb), dtype=torch.long)
    taken = 0
    for i, m in enumerate(used):
        tbl[i, :m] = perm[taken:taken + m]
        taken += m
    tbl = tbl.to(dev)
    rows = (tbl[:, :, None] * bk + torch.arange(bk, device=dev)).reshape(
        b, n_kb * bk)[:, :s]
    pk, pv = (rnd(n_pages * bk, hkv, hd, d=c_dt) for _ in range(2))
    pk[:bk] = 0                                        # the zero page
    pv[:bk] = 0
    pk, pv, sc = quantize(torch, pk, pv, quant)
    kc, vc = take(pk, rows), take(pv, rows)            # the dense cache
    dsc = {n: t[rows] for n, t in sc.items()}
    pidx = torch.gather(tbl, 1, idx.long()).to(torch.int32)
    args = (q, pk, pv, idx, pidx, ok, kvl)
    kw = dict(block_k=bk, **sc)
    got = K.dsa_decode_paged_gather_attention(*args, **kw)
    want = K.dsa_decode_paged_gather_attention_plain(*args, **kw)
    k1 = K.dsa_decode_gather_attention(q, kc, vc, idx, ok, kvl, block_k=bk,
                                       **dsc)
    torch.cuda.synchronize()
    kd, vd = dequantized(torch, pk, pv, sc)
    name = "K4q" if quant else "K4"
    res = dict(geometry=f"B{b} Hq{hq} Hkv{hkv} hd{hd} S{s} bk{bk} nb{nb} "
                        f"pages{n_pages} kv_len{list(kv_len)} q {q_dt} "
                        f"cache {quant or c_dt}",
               **compare(torch, got, want, q_dt),
               equal_k1=bool(torch.equal(got, k1)))
    if not res["ok"]:
        fail(f"{name} disagrees with its plain version: {res}")
    if not res["equal_k1"]:
        fail(f"{name} is not bitwise equal to K1{'q' if quant else ''} on "
             f"the same rows: {res}")
    if quant:
        equal_unquantized(torch, res, name, got,
                          K.dsa_decode_paged_gather_attention(
                              q, kd, vd, idx, pidx, ok, kvl, block_k=bk))
    if not timed:
        return res
    # bytes this call needs: q, the live selected K/V rows, out, indices
    kpos = idx.long()[:, :, None] * bk + torch.arange(bk, device=dev)
    live = (kpos < kvl[:, None, None]) & ok[:, :, None]
    nlive = int(live.sum())
    q_el = q.element_size()
    nbytes = (2 * q.numel() * q_el + 2 * nlive * hkv * cache_bytes_per_row(
        pk, sc) + 3 * idx.numel() * 4 + kvl.numel() * 4)
    flops = 4.0 * nlive * hq * hd
    work_dt = ("bfloat16" if q_dt == c_dt == "bfloat16" and not quant
               else "float32")
    res["bound_ms"], res["bound_by"] = bound(nbytes, flops, work_dt)
    res["ms"] = timer(lambda: K.dsa_decode_paged_gather_attention(
        *args, **kw), iters=50)
    res["host_us"] = timer.host_us(
        lambda: K.dsa_decode_paged_gather_attention(*args, **kw))
    res["plain_ms"] = timer(lambda: K.dsa_decode_paged_gather_attention_plain(
        *args, **kw), iters=10)
    # library yardstick: one SDPA call over the whole (dequantized) pool as
    # one sequence, masked to the physical rows of the live selected keys
    g = hq // hkv
    lib_dt = dt[work_dt]
    kk = kd.transpose(0, 1)[None].repeat_interleave(g, 1).to(lib_dt).expand(
        b, -1, -1, -1)
    vv = vd.transpose(0, 1)[None].repeat_interleave(g, 1).to(lib_dt).expand(
        b, -1, -1, -1)
    qq = q.to(lib_dt)
    phys = pidx.long()[:, :, None] * bk + torch.arange(bk, device=dev)
    rowmask = torch.zeros((b, n_pages * bk), dtype=torch.bool, device=dev)
    bidx = torch.arange(b, device=dev)[:, None, None].expand_as(phys)
    rowmask[bidx[live], phys[live]] = True
    mask = rowmask[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res["library_max_abs_err"] = float(
        (sdpa(qq, kk, vv, attn_mask=mask).float() - want.float()).abs().max())
    res["library_ms"] = timer(lambda: sdpa(qq, kk, vv, attn_mask=mask),
                              iters=20)
    return res


# -- K7 -------------------------------------------------------------------------


def check_k7(torch, timer, *, b, h, s, hd, dtype, seed, timed, w_const=None,
             chunk=32):
    """K7 on (B,H,S,hd) views of model-layout (B,S,H,hd) tensors drawn as
    the reference's kernel tests draw them (w = exp(-exp(0.5 n - 2)), or
    ``w_const``), from a zero state and from a random one, against its
    plain version: y at the dtype's tolerance, s_last at f32's.  Timed on
    the main path's case, a zero state tensor (the prefill cache's)."""
    from repro_torch.kernels import wkv6 as K7
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    r, k, v = rnd(b, s, h, hd), rnd(b, s, h, hd, scale=0.3), rnd(b, s, h, hd)
    w = (torch.full((b, s, h, hd), w_const, device=dev) if w_const
         else torch.exp(-torch.exp(rnd(b, s, h, hd) * 0.5 - 2)))
    r, k, v, w = (t.to(td).transpose(1, 2) for t in (r, k, v, w))
    u = rnd(h, hd, scale=0.1).to(td)
    worst, parts = None, {}
    for name, s0 in (("zero", torch.zeros((b, h, hd, hd), device=dev)),
                     ("random", rnd(b, h, hd, hd, scale=0.5))):
        y, st = K7.wkv6_chunked(r, k, v, w, u, s0, chunk=chunk)
        yp, sp = K7.wkv6_chunked_plain(r, k, v, w, u, s0, chunk=chunk)
        torch.cuda.synchronize()
        for what, c in (("y", compare(torch, y, yp, dtype)),
                        ("s_last", compare(torch, st, sp, "float32"))):
            parts[f"{what} {name} s0"] = c
            if not c["ok"]:
                fail(f"K7 disagrees with its plain version ({what}, {name} "
                     f"s0, B{b} H{h} S{s} hd{hd} {dtype}): {c}")
            if worst is None or c["tol_used"] > worst["tol_used"]:
                worst = c
    res = dict(geometry=f"B{b} H{h} S{s} hd{hd} chunk{chunk} {dtype}"
                        + (f" w={w_const}" if w_const else ""),
               **worst, parts={k: (c["max_abs_err"], c["tol_used"])
                               for k, c in parts.items()})
    if not timed:
        return res
    s0 = torch.zeros((b, h, hd, hd), device=dev)
    el = r.element_size()
    n = b * h * s * hd
    # r, k, v, w read and y written once; u, s0 read and s_last written
    nbytes = 5 * n * el + h * hd * u.element_size() + 2 * b * h * hd * hd * 4
    # per chunk: rr S and k_hat^T v (2 C hd^2 each), the strictly lower
    # triangle of rr kk^T and of its product with v (hd C (C-1) each)
    flops = (b * h * (s // chunk)
             * (4.0 * chunk * hd * hd + 2.0 * hd * chunk * (chunk - 1)))
    res["bound_ms"], res["bound_by"] = bound(nbytes, flops, "float32")
    res["flops"], res["bytes"] = flops, nbytes
    res["ms"] = timer(lambda: K7.wkv6_chunked(r, k, v, w, u, s0,
                                              chunk=chunk), iters=10)
    res["host_us"] = timer.host_us(lambda: K7.wkv6_chunked(
        r, k, v, w, u, s0, chunk=chunk), iters=50)
    res["plain_ms"] = timer(lambda: K7.wkv6_chunked_plain(
        r, k, v, w, u, s0, chunk=chunk), iters=3, warmup=1)
    res["library_ms"] = None          # no single PyTorch call computes wkv6
    return res


# -- engine phases -----------------------------------------------------------


def parity_phase(torch, seed: int) -> dict:
    """yi_6b at full width, 2 layers, f32: kernel mode == block mode, and
    the continuous engine's paths agree with the static engine."""
    from repro_torch.configs.base import get_config
    from repro_torch.inference.engine import Engine
    from repro_torch.models.transformer import init_model
    import numpy as np
    cfg = dataclasses.replace(get_config("yi_6b"), n_layers=2,
                              dtype="float32", param_dtype="float32")
    params = init_model(seed, cfg)
    prompts = np.random.default_rng(seed).integers(
        1, cfg.vocab - 4, size=(2, 512)).astype(np.int32)
    toks = {}
    for mode in ("block", "kernel"):
        eng = Engine(cfg, params, max_len=512 + 16 + 16, long_context=True,
                     dsa_mode=mode)
        toks[mode] = eng.generate(prompts, 16).tokens
    same = bool((toks["block"] == toks["kernel"]).all())
    print(f"parity: 2-layer full-width yi_6b f32, prompt 512, 16 new: "
          f"kernel == block greedy tokens: {same}")
    print(f"  block : {toks['block'][:, :8].tolist()}")
    print(f"  kernel: {toks['kernel'][:, :8].tolist()}")
    if not same:
        fail("kernel mode and block mode disagree on greedy tokens")
    cont = continuous_parity(torch, cfg, params, seed)
    quant = continuous_parity(torch, cfg, params, seed, quant="int8")
    graphs = graph_parity(torch, cfg, params, prompts, seed)
    del params
    torch.cuda.empty_cache()
    return {"same_tokens": same, **cont, "quant": quant, "graphs": graphs}


def graph_parity(torch, cfg, params, prompts, seed: int, n_new: int = 16,
                 max_len: int = 2176) -> dict:
    """Graphed decode == eager decode bit for bit on the kernel path.
    Static: the scan loop (one replay of the step's graph a step, the
    generate run twice on one engine) against the python loop (eager
    steps), f32 and fp8 K/V.  Continuous: a paged engine's segments
    (replays of the masked step's graph) against each request's solo
    python-loop generate, greedy and sampled requests mixed, f32 and int8
    K/V (int8 under blocking admission: chunked admission attends a
    chunk's own rows quantized).  Each engine captures once."""
    import numpy as np
    from repro_torch.inference.engine import Engine
    from repro_torch.inference.scheduler import ContinuousEngine, Request
    out = {}
    for quant in (None, "fp8"):
        kw = dict(max_len=max_len, long_context=True, dsa_mode="kernel",
                  **({} if quant is None else
                     dict(kv_quant=quant, select_dtype="int8")))
        scan = Engine(cfg, params, **kw)
        got = [scan.generate(prompts, n_new).tokens for _ in range(2)]
        want = Engine(cfg, params, loop="python", **kw).generate(
            prompts, n_new).tokens
        same = all(bool((g == want).all()) for g in got)
        label = f"static {quant or 'f32'}"
        print(f"graph parity: {label}, 2-layer full-width yi_6b, prompt "
              f"{prompts.shape[1]}, {n_new} new: scan (graph replays) == "
              f"python (eager) tokens: {same}; {scan.graphs.captures} "
              f"capture, {scan.graphs.replays} replays")
        if not same or scan.graphs.captures != 1:
            fail(f"graph parity, {label}: replayed tokens differ from eager "
                 f"ones or the engine captured {scan.graphs.captures} times")
        out[label] = same
    rng = np.random.default_rng(seed + 3)
    reqs = [Request(i, rng.integers(1, cfg.vocab - 4, size=(n,)).astype(
        np.int32), n_new, greedy=i % 2 == 0, seed=i, temperature=0.8)
        for i, n in enumerate((700, 1100, 512, 900))]
    for quant in (None, "int8"):
        kw = dict(max_len=max_len, long_context=True, dsa_mode="kernel",
                  **({} if quant is None else
                     dict(kv_quant=quant, select_dtype="int8")))
        eng = ContinuousEngine(cfg, params, slots=4, seg_len=16,
                               chunk_tokens=512, paged=True,
                               chunked_prefill=quant is None, **kw)
        got = eng.run(reqs)
        solo = Engine(cfg, params, loop="python", **kw)
        same = all(bool((got[r.rid] == solo.generate(
            r.prompt[None], n_new, greedy=r.greedy, seed=r.seed,
            temperature=r.temperature).tokens[0]).all()) for r in reqs)
        g = eng.graphs
        label = f"continuous {quant or 'f32'}"
        print(f"graph parity: {label} paged, greedy and sampled: segments "
              f"(graph replays) == solo python generate (eager) tokens: "
              f"{same}; {g.captures} capture, {g.replays} replays for "
              f"{eng.stats['decode_steps']} decode steps")
        if (not same or g.captures != 1
                or g.replays != eng.stats["decode_steps"]):
            fail(f"graph parity, {label}: tokens equal {same}, "
                 f"{g.captures} captures, {g.replays} replays")
        out[label] = same
    return out


def continuous_parity(torch, cfg, params, seed: int, lens=(700, 1100, 512,
                                                          900),
                      n_new: int = 16, max_len: int = 2176,
                      quant=None) -> dict:
    """Four requests of mixed prompt buckets: the continuous engine with
    a paged cache on the kernel path (K3, K4), with a dense cache on the
    plain block path, and the static engine on the kernel path (K2, K1)
    serve the same greedy tokens, and the page pool returns full.

    ``quant`` ("int8"): the same with int8 K/V and int8 selection (K3q,
    K4q, K1q).  Chunked admission then attends each chunk's own rows
    through the quantized cache where whole-prompt prefill attends them in
    full precision (the reference does the same; ROADMAP Queue 3), so the
    chunked engines are held to each other and the static engine to the
    paged kernel engine with blocking admission."""
    import numpy as np
    from repro_torch.inference.engine import Engine
    from repro_torch.inference.scheduler import ContinuousEngine, Request
    rng = np.random.default_rng(seed + 1)
    reqs = [Request(i, rng.integers(1, cfg.vocab - 4, size=(n,)).astype(
        np.int32), n_new, seed=i) for i, n in enumerate(lens)]
    qkw = {} if quant is None else dict(kv_quant=quant, select_dtype="int8")
    kw = dict(slots=4, max_len=max_len, seg_len=16, chunk_tokens=512,
              long_context=True, **qkw)
    got, full = {}, True
    runs = [("paged kernel", dict(paged=True, dsa_mode="kernel")),
            ("dense block", dict(dsa_mode="block"))]
    if quant:
        runs.append(("paged kernel blocking", dict(
            paged=True, dsa_mode="kernel", chunked_prefill=False)))
    for name, extra in runs:
        eng = ContinuousEngine(cfg, params, **kw, **extra)
        got[name] = eng.run(reqs)
        if eng.paged:
            full &= eng.pool.available() == eng.pool_pages - 1
        del eng
    static = Engine(cfg, params, max_len=max_len, long_context=True,
                    dsa_mode="kernel", **qkw)
    got["static kernel"] = {r.rid: static.generate(r.prompt[None],
                                                   n_new).tokens[0]
                            for r in reqs}

    def agree(a, b):
        return all((got[a][r.rid] == got[b][r.rid]).all() for r in reqs)

    pairs = ([("paged kernel", "dense block"),
              ("paged kernel blocking", "static kernel")] if quant else
             [(k, "static kernel") for k in got if k != "static kernel"])
    same = all(agree(a, b) for a, b in pairs)
    label = f"{quant} K/V and selection" if quant else "f32"
    print(f"parity: continuous engine, 2-layer full-width yi_6b {label}, "
          f"prompts {list(lens)}, {n_new} new: "
          + "; ".join(f"{a} == {b}: {agree(a, b)}" for a, b in pairs)
          + f"; pool back to full: {full}")
    if quant:
        print(f"  (chunked admission == static generate: "
              f"{agree('paged kernel', 'static kernel')}; not required)")
    for k, toks in got.items():
        print(f"  {k:21s}: {[toks[r.rid][:6].tolist() for r in reqs]}")
    if not same:
        fail(f"the continuous and static engines ({label}) disagree on "
             f"greedy tokens")
    if not full:
        fail("the page pool did not get every page back")
    return {"continuous_same_tokens": same, "pool_full": full}


def continuous_phase(torch, seed: int, quant=None) -> dict:
    """The second path: serve yi_6b at full width through the continuous
    engine, chunked admission (K3) and a paged cache (K4).  ``quant``
    ("int8"): the quantized slice, int8 K/V and int8 selection through
    K3q and K4q."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    n_layers = get_config("yi_6b").n_layers
    vocab = get_config("yi_6b").vocab
    serve.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    results, eng = serve.main([
        "--arch", "yi_6b", "--continuous", "--paged", "--dsa", "--dsa-mode",
        "kernel", "--slots", "4", "--max-len", "8192", "--chunk-tokens",
        "512", "--seg-len", "16", "--requests", "8", "--prompt-len", "4096",
        "--new-tokens", "64", "--rate", "1e9", "--seed", str(seed)]
        + (["--kv-quant", quant, "--select-dtype", "int8"] if quant else []))
    launches = serve.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    slot_bytes = serve.cache_bytes(eng._caches) // eng.slots
    chunk_k, dec_k = ("K3q", "K4q") if quant else ("K3", "K4")
    st = eng.stats
    from repro_torch.inference.scheduler import summarize
    summ = summarize(results, max(r.finish_s for r in results))
    label = f" ({quant} K/V, int8 selection)" if quant else ""
    print(f"continuous slice{label}: {summ['goodput_tok_s']} tok/s "
          f"goodput, latency p50 {summ['p50_latency_s']} s / p95 "
          f"{summ['p95_latency_s']} s, TTFT p50 {summ['p50_ttft_s']} s, "
          f"{st['segments']} segments, {st['admitted']} admissions, "
          f"{st['chunks']} chunk steps, {st['decode_steps']} decode steps, "
          f"peak memory {peak:.2f} GiB ({held:.2f} held at its start), "
          f"pool {slot_bytes} bytes per slot, "
          f"launches " + " ".join(f"{k} {n}" for k, n in launches.items()))
    bad = [r.rid for r in results
           if r.status != "ok" or len(r.tokens) != r.n_new
           or r.tokens.min() < 0 or r.tokens.max() >= vocab]
    if len(results) != 8 or bad:
        fail(f"continuous slice: {len(results)} results, bad {bad}")
    if (st["chunks"] == 0
            or launches[chunk_k] != n_layers * st["chunks"]):
        fail(f"{chunk_k} launched {launches[chunk_k]} times, expected "
             f"{n_layers} x {st['chunks']} chunk steps")
    if (st["decode_steps"] == 0
            or launches[dec_k] != n_layers * st["decode_steps"]):
        fail(f"{dec_k} launched {launches[dec_k]} times, expected "
             f"{n_layers} x {st['decode_steps']} decode steps")
    others = {k: n for k, n in launches.items()
              if k not in (chunk_k, dec_k) and n}
    if others:
        fail(f"the paged, chunked path launched other kernels: {others}")
    if eng.pool.available() != eng.pool_pages - 1:
        fail("the page pool did not get every page back")
    g = eng.graphs
    if g.captures != 1 or g.replays != st["decode_steps"]:
        fail(f"the segments captured {g.captures} graphs and replayed "
             f"{g.replays} times for {st['decode_steps']} decode steps")
    out = {"summary": summ, "peak_gib": peak, "stats": dict(st),
           "slot_bytes": slot_bytes, "launches": launches,
           "capture_ms": [x.capture_ms for x in g.graphs.values()],
           "pool_bytes": g.pool_bytes}
    print(f"  decode graph: capture {out['capture_ms'][0]:.1f} ms, graph "
          f"pool {g.pool_bytes} bytes")
    out["profile"] = continuous_profile(torch, eng, seed, label=label)
    del eng
    return out


def continuous_profile(torch, eng, seed: int, prompt_len: int = 4096,
                       traced_chunks: int = 1, label: str = "") -> dict:
    """Where a chunk step and a segment of the continuous slice spend
    their time: host wall time against the device time of a
    torch.profiler trace, and the top kernels.  One admission group of
    ``slots`` prompts of ``prompt_len`` tokens; its chunk steps run one by
    one."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.inference.scheduler import Request
    eng.reset()
    rng = np.random.default_rng(seed + 2)
    for i in range(eng.slots):
        eng.submit(Request(i, rng.integers(1, eng.cfg.vocab - 4,
                                           size=(prompt_len,)).astype(
                                               np.int32),
                           64, seed=i))
    sink: list = []
    clock = lambda: 0.0
    eng.admit_ready(clock, sink)
    chunk_w = min(eng.chunk_tokens, eng.engine.prompt_bucket(prompt_len))

    def chunk():
        eng.step_prefill(clock, sink, max_chunks=1)

    acts = [ProfilerActivity.CUDA]
    chunk()                                            # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunk()
    torch.cuda.synchronize()
    chunk_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=acts) as prof:
        for _ in range(traced_chunks):
            chunk()
        torch.cuda.synchronize()
    ch = _device_time(prof, "chunk", traced_chunks)
    eng.step_prefill(clock, sink)      # the rest of the group, then decode
    eng.run_segment(clock, sink)                       # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run_segment(clock, sink)
    seg_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=acts) as prof:
        eng.run_segment(clock, sink)
        torch.cuda.synchronize()
    sg = _device_time(prof, "segment", 1)
    _print_profile(f"chunk step{label} ({eng.slots} x {chunk_w} tokens, "
                   f"bucket {eng.engine.prompt_bucket(prompt_len)})",
                   chunk_ms, *ch)
    _print_profile(f"segment{label} ({eng.seg_len} steps x {eng.slots} "
                   f"slots)", seg_ms, *sg)
    return {"chunk_ms": chunk_ms, "chunk_busy_ms": ch[0],
            "segment_ms": seg_ms, "segment_busy_ms": sg[0]}


def _device_time(prof, name: str, n: int) -> tuple:
    """Device busy ms per run and the kernels by device ms per run, from
    the chrome trace of ``prof`` over ``n`` runs: the union of the kernel,
    memcpy and memset intervals, so overlapping work counts once."""
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        path = Path(tmp) / f"trace_{name}.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    events = [e for e in trace["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") in (
                  "kernel", "gpu_memcpy", "gpu_memset")]
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    by_name: dict = {}
    for e in events:
        ms, cnt = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + e["dur"] / 1e3 / n, cnt + 1)
    return busy / 1e3 / n, len(events) / n, by_name


def _print_profile(label: str, wall_ms: float, busy_ms: float,
                   kernels: float, by_name: dict) -> None:
    if not by_name:
        print(f"profile {label}: wall {wall_ms:.2f} ms; the trace holds "
              f"no device events, device time not measured")
        return
    print(f"profile {label}: wall {wall_ms:.2f} ms, device busy "
          f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f} %), "
          f"{kernels:.0f} device kernels")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (ms, cnt) in top:
        print(f"  {ms:8.3f} ms {cnt:6d}x  {name[:90]}")


def profile_phase(torch, seed: int, steps: int = 8, traced: int = 2,
                  arch: str = "yi_6b", dsa_mode: str = "kernel",
                  prompt_len: int = 4096) -> dict:
    """Where a static slice's time goes: host wall time of one prefill and
    of one decode step against the device time a torch.profiler trace
    sees, and the kernels that take most of it.  ``arch`` at full width,
    bf16, batch 4, ``prompt_len`` tokens; DSA archs on ``dsa_mode``."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import get_config
    from repro_torch.inference.engine import Engine
    from repro_torch.models.transformer import init_model
    cfg = get_config(arch)
    dsa = (dict(long_context=True, dsa_mode=dsa_mode) if cfg.dsa.enabled
           else {})
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, init_model(seed, cfg), max_len=prompt_len + 64 + 16,
                 **dsa)
    prompts = np.random.default_rng(seed).integers(
        1, cfg.vocab - 4, size=(4, prompt_len)).astype(np.int32)
    acts = [ProfilerActivity.CUDA]

    def run(tok, steps=steps):
        # the scan loop's steps: a replay of the captured step, then the
        # greedy pick on its logits
        for _ in range(steps):
            tok = step(tok)[:, -1].argmax(-1, keepdim=True)
        return tok

    with torch.inference_mode():
        eng.prefill(prompts)                           # warm
        _, _, prefill_s = eng.prefill(prompts)
        with profile(activities=acts) as prof:
            eng.prefill(prompts)
        pre = _device_time(prof, "prefill", 1)
        step = eng.scan_step(4)                        # the capture
        last, _, _ = eng.prefill(prompts, caches=eng.resident_cache(4))
        tok = run(last[:, -1].argmax(-1, keepdim=True))   # warm
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        tok = run(tok)
        ev[1].record()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / steps * 1e3
        event_ms = ev[0].elapsed_time(ev[1]) / steps
        with profile(activities=acts) as prof:
            tok = run(tok, traced)
            torch.cuda.synchronize()
        dec = _device_time(prof, "decode", traced)
    label = arch if dsa_mode == "kernel" or not dsa else f"{arch} {dsa_mode}"
    _print_profile(f"{label} prefill", prefill_s * 1e3, *pre)
    _print_profile(f"{label} decode step (graph replay)", step_ms, *dec)
    print(f"  decode graph: capture {step.capture_ms:.1f} ms, graph pool "
          f"{step.pool_bytes} bytes, {event_ms:.3f} ms a step between CUDA "
          f"events, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    out = {"prefill_ms": prefill_s * 1e3, "prefill_busy_ms": pre[0],
           "step_ms": step_ms, "step_busy_ms": dec[0],
           "step_event_ms": event_ms, "capture_ms": step.capture_ms,
           "pool_bytes": step.pool_bytes}
    if cfg.rwkv is not None:
        out["unaligned_prefill_ms"] = unaligned_prefill(
            torch, eng, prompts[:, :-1], prefill_s * 1e3)
    del eng
    torch.cuda.empty_cache()
    return out


def unaligned_prefill(torch, eng, prompts, aligned_ms: float) -> float:
    """One prefill whose length is no multiple of 32 (4 x 4095): the
    reference's dispatch sends it through the token scan, a Python loop
    over the tokens of every layer, and never through K7."""
    from repro_torch.kernels.wkv6 import wkv6_chunked
    before = wkv6_chunked.launches
    with torch.inference_mode():
        last, caches, sec = eng.prefill(prompts)
    k7 = wkv6_chunked.launches - before
    finite = bool(torch.isfinite(last).all())
    b, s = prompts.shape
    print(f"{eng.cfg.name} unaligned prefill ({b} x {s}, the token scan): "
          f"{sec * 1e3:.1f} ms ({sec * 1e3 / aligned_ms:.1f} x the {b} x "
          f"{s + 1} prefill through K7; "
          f"{sec * 1e6 / (s * eng.cfg.n_layers):.1f} us a token a layer), "
          f"K7 launches {k7}, logits finite: {finite}", flush=True)
    if k7 or not finite:
        fail(f"unaligned prefill: K7 launched {k7} times, finite {finite}")
    del caches
    return sec * 1e3


def to_cpu(t):
    """A copy of a parameter tree on the CPU (leaves that require grad
    stay leaves that do)."""
    from repro_torch.tree import map_tree
    return map_tree(
        lambda x: x.detach().to("cpu", copy=True).requires_grad_(
            x.requires_grad), t)


def rwkv_parity_phase(torch, seed: int) -> dict:
    """rwkv6_3b at full width, 2 layers, f32: greedy tokens on the card
    (prefill through K7) equal those of the same weights on the CPU (the
    plain version), prompt 512 (chunked), 16 new."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.inference.engine import Engine
    from repro_torch.kernels.wkv6 import wkv6_chunked
    from repro_torch.models.transformer import init_model
    cfg = dataclasses.replace(get_config("rwkv6_3b"), n_layers=2,
                              dtype="float32", param_dtype="float32")
    params = init_model(seed, cfg)
    prompts = np.random.default_rng(seed).integers(
        1, cfg.vocab - 4, size=(2, 512)).astype(np.int32)
    before = wkv6_chunked.launches
    scan = Engine(cfg, params, max_len=512 + 16 + 16)
    card = scan.generate(prompts, 16)
    k7 = wkv6_chunked.launches - before
    eager = Engine(cfg, params, max_len=512 + 16 + 16,
                   loop="python").generate(prompts, 16)
    graphed = (bool((card.tokens == eager.tokens).all())
               and scan.graphs.captures == 1
               and card.decode_dispatches == card.decode_steps)
    print(f"graph parity: 2-layer full-width rwkv6_3b f32, prompt 512, 16 "
          f"new: scan (graph replays) == python (eager) tokens: {graphed}; "
          f"{scan.graphs.captures} capture, {scan.graphs.replays} replays")
    if not graphed:
        fail("rwkv6_3b: the graphed scan loop and the eager loop disagree")
    cpu_params = to_cpu(params)
    del params
    torch.cuda.empty_cache()
    cpu = Engine(cfg, cpu_params, max_len=512 + 16 + 16,
                 device="cpu").generate(prompts, 16)
    same = bool((card.tokens == cpu.tokens).all())
    print(f"parity: 2-layer full-width rwkv6_3b f32, prompt 512, 16 new: "
          f"card (K7, {k7} launches) == CPU (plain) greedy tokens: {same}")
    print(f"  card: {card.tokens[:, :8].tolist()}")
    print(f"  cpu : {cpu.tokens[:, :8].tolist()}")
    if not same:
        fail("rwkv6_3b: the card and the CPU disagree on greedy tokens")
    if k7 != cfg.n_layers:
        fail(f"rwkv6_3b parity: K7 launched {k7} times, expected "
             f"{cfg.n_layers}")
    return {"same_tokens": same, "graphed_same_tokens": graphed}


def faithful_parity_phase(torch, seed: int, n_new: int = 16) -> dict:
    """yi_6b at full width, 2 layers, f32, dsa_mode="faithful" (the token
    top-k of prefill and decode, no kernel): greedy tokens on the card
    equal those on the CPU, full precision and with fp8 K/V and int8
    selection, prompt 512; the card's graphed scan loop gives its python
    loop's tokens bit for bit; and the paged continuous engine's graphed
    segments (chunked admission) give the tokens of the same engine's
    eager segments, greedy and sampled.  No kernel launches."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.inference.engine import Engine
    from repro_torch.inference.scheduler import ContinuousEngine, Request
    from repro_torch.launch import serve
    from repro_torch.models.transformer import init_model
    cfg = dataclasses.replace(get_config("yi_6b"), n_layers=2,
                              dtype="float32", param_dtype="float32")
    params = init_model(seed, cfg)
    cpu_params = to_cpu(params)
    prompts = np.random.default_rng(seed).integers(
        1, cfg.vocab - 4, size=(2, 512)).astype(np.int32)
    serve.reset_launch_counts()
    out = {}
    for quant in (None, "fp8"):
        kw = dict(max_len=512 + 16 + 16, long_context=True,
                  dsa_mode="faithful",
                  **({} if quant is None else
                     dict(kv_quant=quant, select_dtype="int8")))
        scan = Engine(cfg, params, **kw)
        card = scan.generate(prompts, n_new)
        eager = Engine(cfg, params, loop="python", **kw).generate(prompts,
                                                                  n_new)
        cpu = Engine(cfg, cpu_params, device="cpu", **kw).generate(prompts,
                                                                   n_new)
        graphed = (bool((card.tokens == eager.tokens).all())
                   and scan.graphs.captures == 1)
        same = bool((card.tokens == cpu.tokens).all())
        label = "f32" if quant is None else f"{quant} K/V, int8 selection"
        print(f"parity: 2-layer full-width yi_6b faithful {label}, prompt "
              f"512, {n_new} new: card == CPU greedy tokens: {same}; "
              f"graph parity: scan (graph replays) == python (eager) "
              f"tokens: {graphed}, {scan.graphs.captures} capture")
        print(f"  card: {card.tokens[:, :8].tolist()}")
        print(f"  cpu : {cpu.tokens[:, :8].tolist()}")
        if not (same and graphed):
            fail(f"faithful {label}: card == CPU {same}, graphed == eager "
                 f"{graphed}")
        out[label] = same
    rng = np.random.default_rng(seed + 3)
    reqs = [Request(i, rng.integers(1, cfg.vocab - 4, size=(n,)).astype(
        np.int32), n_new, greedy=i % 2 == 0, seed=i, temperature=0.8)
        for i, n in enumerate((700, 1100, 512, 900))]
    kw = dict(max_len=2176, long_context=True, dsa_mode="faithful")
    got = {}
    for label in ("graphed", "eager"):
        eng = ContinuousEngine(cfg, params, slots=4, seg_len=16,
                               chunk_tokens=512, paged=True, **kw)
        if label == "eager":
            eng.graphs = None            # the same segments, step by step
        got[label] = eng.run(reqs)
        if label == "graphed":
            g, steps = eng.graphs, eng.stats["decode_steps"]
        del eng
    same = all(bool((got["graphed"][r.rid] == got["eager"][r.rid]).all())
               for r in reqs)
    print(f"graph parity: continuous faithful paged (chunked admission), "
          f"greedy and sampled: segments (graph replays) == the same "
          f"segments eager, tokens: {same}; {g.captures} capture, "
          f"{g.replays} replays for {steps} decode steps")
    if not same or g.captures != 1 or g.replays != steps:
        fail(f"faithful continuous graph parity: tokens equal {same}, "
             f"{g.captures} captures, {g.replays} replays")
    # not required: this engine's products have other shapes than solo
    # generate's (chunks at admission, all slots in decode), the card's
    # GEMMs round by shape, and a token top-k flips on the last bit
    solo = Engine(cfg, params, loop="python", **kw)
    first = {}
    for r in reqs:
        want = solo.generate(r.prompt[None], n_new, greedy=r.greedy,
                             seed=r.seed, temperature=r.temperature).tokens[0]
        diff = np.nonzero(got["graphed"][r.rid] != want)[0]
        first[r.rid] = int(diff[0]) if diff.size else None
    print(f"  (== solo python generate, not required: first differing "
          f"token per request {first})")
    out["continuous"] = same
    n = {k: v for k, v in serve.launch_counts().items() if v}
    if n:
        fail(f"faithful decode and prefill launched kernels: {n}")
    del solo, params
    torch.cuda.empty_cache()
    return out


def h2o_parity_phase(torch, seed: int, n_new: int = 16,
                     prompt_len: int = 4352) -> dict:
    """h2o_danube_1_8b at full width, 2 layers, f32, prompts of 4352
    tokens: past the 4096-token window, so the ring wraps at prefill and
    again in decode.  DSA off: the card's greedy tokens equal the CPU's.
    DSA on the kernel path (K2 with the window, once a layer) equals the
    plain block path on the card, and the graphed scan loop gives the
    python loop's tokens bit for bit."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.inference.engine import Engine
    from repro_torch.kernels.dsa_attention import dsa_block_sparse_attention
    from repro_torch.models.transformer import init_model
    cfg = dataclasses.replace(get_config("h2o_danube_1_8b"), n_layers=2,
                              dtype="float32", param_dtype="float32")
    params = init_model(seed, cfg)
    prompts = np.random.default_rng(seed).integers(
        1, cfg.vocab - 4, size=(2, prompt_len)).astype(np.int32)
    max_len = prompt_len + n_new + 16
    toks = {}
    for name, kw in (("off", {}),
                     ("block", dict(long_context=True, dsa_mode="block")),
                     ("kernel", dict(long_context=True, dsa_mode="kernel"))):
        before = dsa_block_sparse_attention.launches
        eng = Engine(cfg, params, max_len=max_len, **kw)
        toks[name] = eng.generate(prompts, n_new).tokens
        k2 = dsa_block_sparse_attention.launches - before
        if k2 != (cfg.n_layers if name == "kernel" else 0):
            fail(f"h2o parity ({name}): K2 launched {k2} times")
        if name == "kernel":
            ring = eng.resident_cache(2)["groups"][0]["b0"]["attn"]["k"]
            eager = Engine(cfg, params, max_len=max_len, loop="python",
                           **kw).generate(prompts, n_new).tokens
            graphed = (bool((toks[name] == eager).all())
                       and eng.graphs.captures == 1)
        del eng
    cpu = Engine(cfg, to_cpu(params), max_len=max_len,
                 device="cpu").generate(prompts, n_new).tokens
    same_cpu = bool((toks["off"] == cpu).all())
    same_k = bool((toks["kernel"] == toks["block"]).all())
    print(f"parity: 2-layer full-width h2o_danube_1_8b f32, prompt "
          f"{prompt_len} (ring of {ring.shape[1]} rows, wrapped at "
          f"prefill and in decode), {n_new} new: DSA off card == CPU "
          f"greedy tokens: {same_cpu}; kernel (K2 with window, "
          f"{cfg.n_layers} launches) == block: {same_k}; graph parity, "
          f"kernel path: scan (graph replays) == python (eager): "
          f"{graphed}")
    for k, t in list(toks.items()) + [("cpu off", cpu)]:
        print(f"  {k:8s}: {t[:, :8].tolist()}")
    if not (same_cpu and same_k and graphed):
        fail("h2o_danube_1_8b parity failed")
    del params
    torch.cuda.empty_cache()
    return {"card_cpu": same_cpu, "kernel_block": same_k,
            "graphed": graphed}


# -- training -----------------------------------------------------------------

# a train step, card against CPU.  Metrics: the predictor's 4-bit fake
# quant rounds an input one ulp apart on the two devices to the next level
# now and then, which moves S~ by a whole step, so mse, the gradients and
# grad_norm differ by ~1e-4 where ce agrees.  New params: the first AdamW
# step moves each element by about lr * sign(g), so a gradient within
# rounding of zero may step the other way (|d| <= 2 lr); nearly all agree
# to 1e-5
TRAIN_METRIC_RTOL = 1e-3
TRAIN_PARAM_SHARE = 0.99


def _p_leaves(params):
    """The frozen DSA projections P of a parameter tree."""
    from repro_torch.optim.adamw import is_frozen
    from repro_torch.tree import named_leaves
    return {k: v for k, v in named_leaves(params) if is_frozen(k)}


def train_parity_phase(torch, seed: int) -> dict:
    """stablelm_3b at full width (d 2560, 32 heads of 80, vocab 50304),
    2 layers, f32, remat on: one train step (``lm_batches``, batch 2 x 512
    tokens, 4 key blocks of which 2 are kept, 2 microbatches) on the card
    and on the CPU from the same params.  loss, ce, mse and grad_norm
    agree at TRAIN_METRIC_RTOL, every new param within 2 lr with at least
    TRAIN_PARAM_SHARE of the elements within 1e-5, P is unchanged bit for
    bit on both, and no kernel launches.  Then the eval step on the kernel
    path (K2 once a layer, no other kernel) gives the block path's ce at
    f32's tolerance."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import DataConfig, lm_batches
    from repro_torch.launch import serve
    from repro_torch.models.attention import RunFlags
    from repro_torch.optim import adamw
    from repro_torch.training import steps as ST
    from repro_torch.tree import named_leaves
    cfg = dataclasses.replace(get_config("stablelm_3b"), n_layers=2,
                              dtype="float32", param_dtype="float32")
    opt = adamw.OptConfig(lr=1e-3, total_steps=10, warmup_steps=2)
    batch = next(lm_batches(DataConfig(vocab=cfg.vocab, seq_len=512,
                                       global_batch=2, seed=seed)))
    card = ST.init_train_state(seed, cfg, opt)
    cpu_params = to_cpu(card["params"])
    cpu = {"params": cpu_params, "opt": adamw.init(opt, cpu_params),
           "step": 0}
    p0 = {k: v.cpu() for k, v in _p_leaves(card["params"]).items()}
    step = ST.make_train_step(cfg, opt, microbatches=2)
    serve.reset_launch_counts()
    t0 = time.perf_counter()
    card, m_card = step(card, batch)
    m_card = {k: float(v) for k, v in m_card.items()}
    card_s = time.perf_counter() - t0
    n = {k: v for k, v in serve.launch_counts().items() if v}
    t0 = time.perf_counter()
    cpu, m_cpu = step(cpu, batch)
    cpu_s = time.perf_counter() - t0
    m_cpu = {k: float(v) for k, v in m_cpu.items()}
    rel = {k: abs(m_card[k] - m_cpu[k]) / abs(m_cpu[k])
           for k in ("loss", "ce", "mse", "grad_norm")}
    lr = m_cpu["lr"]
    want = dict(named_leaves(cpu["params"]))
    worst, within, total = 0.0, 0, 0
    for path, p in named_leaves(card["params"]):
        d = (p.detach().cpu() - want[path].detach()).abs()
        worst = max(worst, float(d.max()))
        within += int((d <= 1e-5).sum())
        total += d.numel()
    frozen = all(torch.equal(p0[k], v.cpu()) and torch.equal(
        p0[k], want[k]) for k, v in _p_leaves(card["params"]).items())
    print(f"train parity: 2-layer full-width stablelm_3b f32 (remat), batch "
          f"2 x 512, 2 microbatches: card {card_s:.2f} s, CPU {cpu_s:.2f} "
          f"s; card vs CPU relative differences "
          + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
          + f" (rtol {TRAIN_METRIC_RTOL:g}); new params max |d| {worst:.3g} "
          f"(bound 2 lr = {2 * lr:.3g}), {100 * within / total:.3f} % within "
          f"1e-5; P unchanged: {frozen}; kernels launched: {n or 'none'}",
          flush=True)
    print(f"  card: {', '.join(f'{k} {m_card[k]:.6f}' for k in rel)}")
    print(f"  cpu : {', '.join(f'{k} {m_cpu[k]:.6f}' for k in rel)}")
    if (n or not frozen or worst > 2 * lr
            or within < TRAIN_PARAM_SHARE * total
            or max(rel.values()) > TRAIN_METRIC_RTOL):
        fail("training parity (card vs CPU) failed")
    del cpu, cpu_params
    serve.reset_launch_counts()
    ce = {mode: float(ST.make_eval_step(cfg, RunFlags(
        mode="train", with_mse=False, dsa_mode=mode))(card["params"],
                                                      batch)["ce"])
          for mode in ("block", "kernel")}
    n = {k: v for k, v in serve.launch_counts().items() if v}
    same = abs(ce["kernel"] - ce["block"]) <= 1e-5 * abs(ce["block"])
    print(f"eval on the trained model: ce kernel {ce['kernel']:.7f}, block "
          f"{ce['block']:.7f} (rtol 1e-5: {same}); launches {n}", flush=True)
    if not same or n != {"K2": cfg.n_layers}:
        fail(f"eval on the kernel path: ce {ce}, launches {n}")
    del card
    torch.cuda.empty_cache()
    return {"rel": rel, "params_max_abs": worst, "eval_ce": ce}


def train_slice(torch, seed: int) -> dict:
    """Train stablelm_3b at full width through ``repro_torch.launch.train``:
    32 layers in bf16, DSA on the block path, remat, 4 steps of batch 4 x
    4096 tokens in 2 microbatches.  Every metric finite, P unchanged, no
    kernel launched.  Prints the median step time over steps 2-4,
    tokens/s, the 6 N D share of the bf16 peak, peak memory and the bytes
    of params, grads and moments; then profiles one more step and the
    optimizer update alone."""
    import math
    import statistics
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import DataConfig, lm_batches
    from repro_torch.launch import serve, train
    from repro_torch.models.transformer import init_model
    from repro_torch.optim import adamw
    from repro_torch.training import steps as ST
    from repro_torch.tree import named_leaves
    cfg = get_config("stablelm_3b")
    b, s, steps = 4, 4096, 4
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2**30
    serve.reset_launch_counts()
    res = train.main(["--arch", "stablelm_3b", "--steps", str(steps),
                      "--seq", str(s), "--batch", str(b), "--microbatches",
                      "2", "--data", "lm", "--log-interval", "1",
                      "--seed", str(seed)])
    n = {k: v for k, v in serve.launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**30
    state = res.state
    params = state["params"]
    med = statistics.median(res.step_s[1:])
    leaves = list(named_leaves(params))
    n_blocks = sum(p.numel() for k, p in leaves if k.startswith("/groups/"))
    n_head = params["lm_head"].numel()
    flops = 6 * (n_blocks + n_head) * b * s
    share = flops / med / PEAK_FLOPS["bfloat16"]
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    p_bytes = nbytes(p for _, p in leaves)
    g_bytes = nbytes(p for _, p in leaves if p.requires_grad)
    m_bytes = nbytes(t for name in ("m", "v")
                     for _, t in named_leaves(state["opt"][name]))
    finite = all(math.isfinite(v) for m in res.metrics for v in m.values())
    print(f"train slice (stablelm_3b, 32 layers bf16, DSA block path, "
          f"remat, {steps} steps of {b} x {s} in 2 microbatches): step "
          f"{med * 1e3:.1f} ms (median of steps 2-{steps}; all: "
          + ", ".join(f"{t * 1e3:.1f}" for t in res.step_s)
          + f" ms), {b * s / med:.0f} tok/s; 6 N D / step time / 989 "
          f"TFLOP/s = 6 x {n_blocks + n_head:,} x {b * s} / {med:.4f} s / "
          f"989e12 = {100 * share:.2f} % (N: the 32 blocks' {n_blocks:,} "
          f"params and the lm head's {n_head:,}; the embedding lookup and "
          f"the remat recompute are not counted); peak memory {peak:.2f} "
          f"GiB ({held:.2f} held at its start); params {p_bytes:,} B, "
          f"grads {g_bytes:,} B, moments {m_bytes:,} B; metrics finite: "
          f"{finite}; kernels launched: {n or 'none'}", flush=True)
    if n or not finite:
        fail(f"the train slice launched {n}, metrics finite {finite}")

    # the profile: one more step, then the optimizer update on its own
    opt = adamw.OptConfig(total_steps=steps + 2, warmup_steps=1)
    flags = ST.default_flags(cfg)
    batch = next(lm_batches(DataConfig(vocab=cfg.vocab, seq_len=s,
                                       global_batch=b, seed=seed + 1)))
    step = ST.make_train_step(cfg, opt, flags, microbatches=2)
    acts = [ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        wall = time.perf_counter() - t0
    tr = _device_time(prof, "train", 1)
    _print_profile(f"stablelm_3b train step ({b} x {s}, 2 microbatches)",
                   wall * 1e3, *tr)
    grads, _ = ST.accumulate_grads(params, cfg, flags, batch, 2)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    t0 = time.perf_counter()
    ev[0].record()
    adamw.apply_updates(opt, params, grads, state["opt"])
    ev[1].record()
    torch.cuda.synchronize()
    upd_ms = (time.perf_counter() - t0) * 1e3
    grads, _ = ST.accumulate_grads(params, cfg, flags, batch, 2)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        adamw.apply_updates(opt, params, grads, state["opt"])
        torch.cuda.synchronize()
        upd_traced = time.perf_counter() - t0
    up = _device_time(prof, "update", 1)
    print(f"optimizer update alone: {upd_ms:.1f} ms host clock, "
          f"{ev[0].elapsed_time(ev[1]):.1f} ms between CUDA events, "
          f"{len(leaves)} leaves", flush=True)
    _print_profile("optimizer update (traced)", upd_traced * 1e3, *up)
    del grads
    got = {k: v.clone() for k, v in _p_leaves(params).items()}
    del state, params, res, leaves
    torch.cuda.empty_cache()
    fresh = init_model(seed, cfg)
    frozen = all(torch.equal(v, got[k])
                 for k, v in _p_leaves(fresh).items())
    del fresh, got
    torch.cuda.empty_cache()
    print(f"train slice: P unchanged after {steps + 3} updates: {frozen}",
          flush=True)
    if not frozen:
        fail("the train slice moved P")
    return {"step_ms": med * 1e3, "tok_s": b * s / med, "mfu_6nd": share,
            "peak_gib": peak, "params_bytes": p_bytes, "grads_bytes": g_bytes,
            "moments_bytes": m_bytes, "profile_wall_ms": wall * 1e3,
            "profile_busy_ms": tr[0], "update_ms": upd_ms,
            "update_busy_ms": up[0]}


def static_slice(torch, seed: int, arch: str, dsa_mode: str, want,
                 prompt_len: int = 4096, quant=None) -> dict:
    """Serve ``arch`` at full width through ``repro_torch.launch.serve``:
    all layers in bf16, batch 4, ``prompt_len`` tokens, 64 new (32 with
    ``quant``: an fp8 K/V cache and int8 selection), DSA on ``dsa_mode``
    (an arch without DSA falls back to off).  ``want(n_layers, steps)``
    gives the launches each kernel must show; every other kernel must
    show none."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    from repro_torch.models.attention import RunFlags
    from repro_torch.models.transformer import init_cache
    cfg = get_config(arch)
    n_new = 32 if quant else 64
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    serve.reset_launch_counts()
    res = serve.main(["--arch", arch, "--batch", "4", "--prompt-len",
                      str(prompt_len), "--new-tokens", str(n_new), "--dsa",
                      "--dsa-mode", dsa_mode, "--seed", str(seed)]
                     + (["--kv-quant", quant, "--select-dtype", "int8"]
                        if quant else []))
    n = serve.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    dsa = cfg.dsa.enabled
    flags = RunFlags(mode="decode", long_context=dsa,
                     kv_quant=quant if dsa else None,
                     select_dtype="int8" if quant and dsa else "float32")
    row = serve.cache_bytes(init_cache(cfg, 1, prompt_len + n_new + 16,
                                       flags, dtype=torch.float32,
                                       device="meta"))
    label = (f"{arch} {dsa_mode if dsa else 'no DSA'}"
             + (f", {quant} K/V, int8 selection" if quant else ""))
    print(f"slice ({label}): prefill {res.prefill_s * 1e3:.1f} ms, decode "
          f"{res.tokens_per_s:.1f} tok/s over {res.decode_steps} steps, "
          f"peak memory {peak:.2f} GiB ({held:.2f} held at its start), "
          f"cache {row} bytes per batch row, launches "
          + " ".join(f"{k} {v}" for k, v in n.items()))
    expect = want(cfg.n_layers, res.decode_steps)
    bad = {k: v for k, v in n.items() if v != expect.get(k, 0)}
    if bad:
        fail(f"the slice ({label}) launched {bad}, expected {expect}")
    if res.decode_dispatches != res.decode_steps:
        fail(f"{res.decode_dispatches} graph replays for "
             f"{res.decode_steps} decode steps")
    tok = res.tokens
    if tok.shape != (4, n_new) or tok.min() < 0 or tok.max() >= cfg.vocab:
        fail(f"bad tokens: shape {tok.shape}, range {tok.min()}..{tok.max()}")
    return {"prefill_ms": res.prefill_s * 1e3,
            "decode_tok_s": res.tokens_per_s, "decode_s": res.decode_s,
            "decode_steps": res.decode_steps, "peak_gib": peak,
            "cache_bytes_per_row": row, "launches": n}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        fail(f"repro_torch not found next to this script ({e})")

    card = smi()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    secs = build.build_all()
    print(f"build: {secs:.1f} s for {len(build.SOURCES)} sources")
    spills = []
    for name, log in build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
            if (name in NO_SPILL and "spill" in line
                    and "0 bytes spill stores, 0 bytes spill loads" not in line):
                spills.append(f"{name}: {line.strip()}")
    if spills:
        fail(f"ptxas spills registers in {spills}")

    timer = Timer(torch)
    k1_checks = [
        check_k1(torch, timer, b=2, hq=8, hkv=2, hd=16, s=100, bk=16,
                 q_dt="float32", c_dt="float32", kv_len=[100, 63], nb=5,
                 seed=args.seed, timed=False),
        check_k1(torch, timer, b=4, hq=32, hkv=4, hd=128, s=4224, bk=128,
                 q_dt="bfloat16", c_dt="bfloat16",
                 kv_len=[4160, 4100, 4097, 4133], nb=6, seed=args.seed,
                 timed=True),
        # the main path's case: bf16 q against the default f32 cache
        check_k1(torch, timer, b=4, hq=32, hkv=4, hd=128, s=4224, bk=128,
                 q_dt="bfloat16", c_dt="float32",
                 kv_len=[4160, 4100, 4097, 4133], nb=6, seed=args.seed,
                 timed=True),
        # the full-width body (hd 128, G 8) at f32 precision
        check_k1(torch, timer, b=4, hq=32, hkv=4, hd=128, s=4224, bk=128,
                 q_dt="float32", c_dt="float32",
                 kv_len=[4160, 4100, 4097, 4133], nb=6, seed=args.seed,
                 timed=False),
    ]
    k2_checks = [
        check_k2(torch, timer, b=2, hq=8, hkv=2, hd=16, l=128, blk=16, nb=3,
                 dtype="float32", seed=args.seed, timed=False),
        check_k2(torch, timer, b=2, hq=8, hkv=2, hd=16, l=128, blk=16, nb=3,
                 dtype="bfloat16", seed=args.seed, timed=False),
        check_k2(torch, timer, b=4, hq=32, hkv=4, hd=128, l=4096, blk=128,
                 nb=3, dtype="bfloat16", seed=args.seed, timed=True),
        # the f32 body at full width (the f32 parity phase runs it)
        check_k2(torch, timer, b=1, hq=32, hkv=4, hd=128, l=1024, blk=128,
                 nb=3, dtype="float32", seed=args.seed, timed=False),
        # stablelm_3b's prefill: hd 80 (a 160-byte row, the 128-column
        # instance), one query head per KV head
        check_k2(torch, timer, b=1, hq=32, hkv=32, hd=80, l=4096, blk=128,
                 nb=3, dtype="bfloat16", seed=args.seed, timed=False),
    ]
    # the sliding-window path: h2o_danube_1_8b's reduced geometry (window
    # 64 at block 16) in both bodies, its f32 parity run's (hd 80, G 4,
    # window 4096, L 4352) and its prefill's, timed (the kernels line's
    # window entry)
    k2w_checks = [
        check_k2(torch, timer, b=2, hq=4, hkv=2, hd=16, l=256, blk=16, nb=2,
                 window=64, dtype=dt, seed=args.seed, timed=False)
        for dt in ("float32", "bfloat16")] + [
        check_k2(torch, timer, b=1, hq=32, hkv=8, hd=80, l=4352, blk=128,
                 nb=6, window=4096, dtype="float32", seed=args.seed,
                 timed=False),
        check_k2(torch, timer, b=4, hq=32, hkv=8, hd=80, l=8192, blk=128,
                 nb=6, window=4096, dtype="bfloat16", seed=args.seed,
                 timed=True)]
    k3_checks = [
        check_k3(torch, timer, b=2, hq=8, hkv=2, hd=16, s=100, c=32, blk=16,
                 q_dt="float32", c_dt="float32", q_off=[64, 32],
                 chunk_len=[36, 5], seed=args.seed, timed=False),
    ] + [
        # yi_6b's chunk: C 512 at depths 512..3584 of a 4096-row bucket, the
        # last row a partial final chunk; bf16 q against the default f32
        # cache is the main path's case
        check_k3(torch, timer, b=4, hq=32, hkv=4, hd=128, s=4096, c=512,
                 blk=128, q_dt=q_dt, c_dt=c_dt,
                 q_off=[3584, 2048, 512, 3072], chunk_len=[512, 512, 512, 300],
                 seed=args.seed, timed=(q_dt, c_dt) == ("bfloat16", "float32"))
        for q_dt, c_dt in (("bfloat16", "float32"), ("bfloat16", "bfloat16"),
                           ("float32", "float32"))]
    k4_checks = [
        check_k4(torch, timer, b=2, hq=8, hkv=2, hd=16, s=100, bk=16,
                 q_dt="float32", c_dt="float32", kv_len=[100, 63], nb=5,
                 seed=args.seed, timed=False)
    ] + [
        check_k4(torch, timer, b=4, hq=32, hkv=4, hd=128, s=4224, bk=128,
                 q_dt=q_dt, c_dt=c_dt, kv_len=[4160, 4100, 4097, 4133],
                 nb=6, seed=args.seed,
                 timed=(q_dt, c_dt) == ("bfloat16", "float32"))
        for q_dt, c_dt in (("bfloat16", "bfloat16"), ("bfloat16", "float32"),
                           ("float32", "float32"))] + [
        # the shape the continuous slice gives K4 (the kernels line's
        # entry): a logical cache of 64 blocks (max_len 8192) over the
        # default pool of 4 x 64 + 1 pages, a 9-block selection, ragged
        # depths, bf16 q against the default f32 pool
        check_k4(torch, timer, b=4, hq=32, hkv=4, hd=128, s=8192, bk=128,
                 q_dt="bfloat16", c_dt="float32",
                 kv_len=[4160, 2650, 1200, 3700], nb=9, pages=4 * 64 + 1,
                 seed=args.seed, timed=True)]
    # the quantized bodies (K6 of the TPU kernels): int8 and fp8 caches at
    # the reduced geometry and at the shapes the quantized slices give
    # them, bf16 q; K5 and K5q on a shuffled pool holding K3's cache
    q_checks = {}
    for quant in ("int8", "fp8"):
        q_checks["K1q", quant] = [
            check_k1(torch, timer, b=2, hq=8, hkv=2, hd=16, s=100, bk=16,
                     q_dt="float32", c_dt="float32", kv_len=[100, 63], nb=5,
                     seed=args.seed, timed=False, quant=quant),
            check_k1(torch, timer, b=4, hq=32, hkv=4, hd=128, s=4224,
                     bk=128, q_dt="bfloat16", c_dt="float32",
                     kv_len=[4160, 4100, 4097, 4133], nb=6, seed=args.seed,
                     timed=True, quant=quant)]
        q_checks["K4q", quant] = [
            check_k4(torch, timer, b=2, hq=8, hkv=2, hd=16, s=100, bk=16,
                     q_dt="float32", c_dt="float32", kv_len=[100, 63], nb=5,
                     seed=args.seed, timed=False, quant=quant),
            check_k4(torch, timer, b=4, hq=32, hkv=4, hd=128, s=8192,
                     bk=128, q_dt="bfloat16", c_dt="float32",
                     kv_len=[4160, 2650, 1200, 3700], nb=9,
                     pages=4 * 64 + 1, seed=args.seed, timed=True,
                     quant=quant)]
        q_checks["K3q", quant] = [
            check_k3(torch, timer, b=2, hq=8, hkv=2, hd=16, s=100, c=32,
                     blk=16, q_dt="float32", c_dt="float32", q_off=[64, 32],
                     chunk_len=[36, 5], seed=args.seed, timed=False,
                     quant=quant),
            check_k3(torch, timer, b=4, hq=32, hkv=4, hd=128, s=4096, c=512,
                     blk=128, q_dt="bfloat16", c_dt="float32",
                     q_off=[3584, 2048, 512, 3072],
                     chunk_len=[512, 512, 512, 300], seed=args.seed,
                     timed=True, quant=quant)]
    for quant in (None, "int8", "fp8"):
        q_checks["K5q" if quant else "K5", quant] = [
            check_k3(torch, timer, b=2, hq=8, hkv=2, hd=16, s=96, c=32,
                     blk=16, q_dt="float32", c_dt="float32", q_off=[64, 32],
                     chunk_len=[32, 5], seed=args.seed, timed=False,
                     quant=quant, paged=True),
            check_k3(torch, timer, b=4, hq=32, hkv=4, hd=128, s=4096, c=512,
                     blk=128, q_dt="bfloat16", c_dt="float32",
                     q_off=[3584, 2048, 512, 3072],
                     chunk_len=[512, 512, 512, 300], seed=args.seed,
                     timed=True, quant=quant, paged=True)]
    for name, checks in [("K1 dsa_decode", k1_checks),
                         ("K2 dsa_attention", k2_checks),
                         ("K2 dsa_attention (window)", k2w_checks),
                         ("K3 dsa_chunk_prefill", k3_checks),
                         ("K4 dsa_decode_paged", k4_checks)] + [
            (f"{k} {q or ''}".strip(), v) for (k, q), v in q_checks.items()]:
        for c in checks:
            line = (f"{name} [{c['geometry']}]: max abs err "
                    f"{c['max_abs_err']:.3g} (atol {c['tol'][0]:g} + rtol "
                    f"{c['tol'][1]:g} x |plain|; {100 * c['tol_used']:.1f} % "
                    f"of it used)")
            for key, what in (("equal_k1", "K1"), ("equal_k3", "K3"),
                              ("equal_unquantized", "the unquantized "
                               "kernel on the dequantized cache")):
                if key in c:
                    line += f", bitwise equal to {what}: {c[key]}"
            if "ms" in c:
                line += (f", kernel {c['ms']:.4f} ms (host enqueue "
                         f"{c['host_us']:.1f} us), plain "
                         f"{c['plain_ms']:.4f} ms, library "
                         f"{c['library_ms']:.4f} ms, bound "
                         f"{c['bound_ms']:.4f} ms ({c['bound_by']})")
            print(line, flush=True)
    k7_checks = [
        check_k7(torch, timer, b=2, h=4, s=128, hd=16, dtype="float32",
                 seed=args.seed, timed=False),
        check_k7(torch, timer, b=2, h=4, s=128, hd=16, dtype="float32",
                 seed=args.seed, timed=False, w_const=0.3),
        # rwkv6_3b's prefill: the main path's case is bf16
        check_k7(torch, timer, b=4, h=40, s=4096, hd=64, dtype="bfloat16",
                 seed=args.seed, timed=True),
        check_k7(torch, timer, b=4, h=40, s=4096, hd=64, dtype="float32",
                 seed=args.seed, timed=False),
        check_k7(torch, timer, b=4, h=40, s=4096, hd=64, dtype="float32",
                 seed=args.seed, timed=False, w_const=0.3),
        # the main path's dtype where the clamp binds, from a zero and a
        # random state
        check_k7(torch, timer, b=4, h=40, s=4096, hd=64, dtype="bfloat16",
                 seed=args.seed + 1, timed=False, w_const=0.3),
    ]
    for c in k7_checks:
        line = (f"K7 wkv6 [{c['geometry']}]: max abs err "
                f"{c['max_abs_err']:.3g} (atol {c['tol'][0]:g} + rtol "
                f"{c['tol'][1]:g} x |plain|; {100 * c['tol_used']:.1f} % of "
                f"it used; y and s_last, zero and random s0: "
                + ", ".join(f"{k} {e:.3g}/{100 * u:.1f} %"
                            for k, (e, u) in c["parts"].items()) + ")")
        if "ms" in c:
            line += (f", kernel {c['ms']:.4f} ms (host enqueue "
                     f"{c['host_us']:.1f} us), plain {c['plain_ms']:.4f} "
                     f"ms, library none, bound {c['bound_ms']:.4f} ms "
                     f"({c['bound_by']}: {c['flops'] / 1e9:.2f} GFLOP, "
                     f"{c['bytes'] / 1e9:.3f} GB)")
        print(line, flush=True)
    torch.cuda.empty_cache()

    # each path: its launch counts set to 0 just before it, read just after
    parity_phase(torch, args.seed)
    # yi_6b: K2 once a layer in prefill, K1 (K1q) once a layer a step
    launches = {"static": static_slice(
        torch, args.seed, "yi_6b", "kernel",
        lambda n, steps: {"K2": n, "K1": n * steps})["launches"]}
    torch.cuda.empty_cache()
    launches["continuous"] = continuous_phase(torch, args.seed)["launches"]
    torch.cuda.empty_cache()
    launches["quant static"] = static_slice(
        torch, args.seed, "yi_6b", "kernel",
        lambda n, steps: {"K2": n, "K1q": n * steps},
        quant="fp8")["launches"]
    torch.cuda.empty_cache()
    launches["quant continuous"] = continuous_phase(
        torch, args.seed, quant="int8")["launches"]
    torch.cuda.empty_cache()
    profile_phase(torch, args.seed)
    rwkv_parity_phase(torch, args.seed)
    # rwkv6_3b: K7 once a layer in prefill, no attention kernel
    launches["rwkv"] = static_slice(
        torch, args.seed, "rwkv6_3b", "kernel",
        lambda n, steps: {"K7": n})["launches"]
    torch.cuda.empty_cache()
    profile_phase(torch, args.seed, arch="rwkv6_3b")
    faithful_parity_phase(torch, args.seed)
    h2o_parity_phase(torch, args.seed)
    # yi_6b faithful: the token path in prefill and a token top-k a decode
    # step, no kernel at all
    launches["faithful"] = static_slice(
        torch, args.seed, "yi_6b", "faithful",
        lambda n, steps: {})["launches"]
    torch.cuda.empty_cache()
    profile_phase(torch, args.seed, dsa_mode="faithful")
    # h2o: K2 with the 4096-token window once a layer in prefill; decode
    # attends the ring with no kernel (an SWA cache has no kt)
    launches["h2o"] = static_slice(
        torch, args.seed, "h2o_danube_1_8b", "kernel",
        lambda n, steps: {"K2": n}, prompt_len=8192)["launches"]
    torch.cuda.empty_cache()
    profile_phase(torch, args.seed, arch="h2o_danube_1_8b", prompt_len=8192)
    # training: the plain model path, no kernel; eval runs K2
    train_parity_phase(torch, args.seed)
    train_slice(torch, args.seed)

    src = "src/repro_torch/kernels/csrc/"
    rep = "src/repro/kernels/"
    # no model path runs K5 or K5q (the staging caches are dense): their
    # launches are the sum of their counts over the four path runs
    paths = {k: sum(n[k] for n in launches.values()) for k in ("K5", "K5q")}
    kernels = []
    for name, cu, tpu, c, extra, n in (
            ("dsa_block_sparse_attention", "dsa_attention.cu",
             "dsa_attention.py:77", k2_checks[2], k2_checks,
             launches["static"]["K2"]),
            # K2's sliding-window path at h2o_danube_1_8b's prefill
            ("dsa_block_sparse_attention (window)", "dsa_attention.cu",
             "dsa_attention.py:77", k2w_checks[-1], k2w_checks,
             launches["h2o"]["K2"]),
            ("dsa_decode_gather_attention", "dsa_decode.cu",
             "dsa_decode.py:185", k1_checks[2], k1_checks,
             launches["static"]["K1"]),
            ("dsa_chunk_gather_attention", "dsa_chunk_prefill.cu",
             "dsa_chunk_prefill.py:198", k3_checks[1], k3_checks,
             launches["continuous"]["K3"]),
            ("dsa_decode_paged_gather_attention", "dsa_decode.cu",
             "dsa_decode.py:116", k4_checks[-1], k4_checks,
             launches["continuous"]["K4"]),
            ("dsa_chunk_paged_gather_attention", "dsa_chunk_prefill.cu",
             "dsa_chunk_prefill.py:126", q_checks["K5", None][1],
             q_checks["K5", None], paths["K5"]),
            # K1q on the fp8 static slice, K3q/K4q on the int8 continuous one
            ("dsa_decode_gather_attention_quant", "dsa_decode.cu",
             "dsa_decode.py:90", q_checks["K1q", "fp8"][1],
             q_checks["K1q", "int8"] + q_checks["K1q", "fp8"],
             launches["quant static"]["K1q"]),
            ("dsa_decode_paged_gather_attention_quant", "dsa_decode.cu",
             "dsa_decode.py:108", q_checks["K4q", "int8"][1],
             q_checks["K4q", "int8"] + q_checks["K4q", "fp8"],
             launches["quant continuous"]["K4q"]),
            ("dsa_chunk_gather_attention_quant", "dsa_chunk_prefill.cu",
             "dsa_chunk_prefill.py:98", q_checks["K3q", "int8"][1],
             q_checks["K3q", "int8"] + q_checks["K3q", "fp8"],
             launches["quant continuous"]["K3q"]),
            ("dsa_chunk_paged_gather_attention_quant",
             "dsa_chunk_prefill.cu", "dsa_chunk_prefill.py:117",
             q_checks["K5q", "int8"][1],
             q_checks["K5q", "int8"] + q_checks["K5q", "fp8"],
             paths["K5q"])):
        kernels.append({
            "name": name, "route": "cuda", "source": src + cu,
            "replaces": rep + tpu, "launches": n,
            "max_abs_err": c["max_abs_err"],
            "ms": c["ms"], "kernel_ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"], "host_us": c["host_us"],
            "geometry": c["geometry"],
            "checks": [{k: x[k] for k in ("geometry", "max_abs_err", "tol",
                                          "tol_used")}
                       for x in extra]})
    c = k7_checks[2]
    kernels.append({
        "name": "wkv6_chunked", "route": "cuda", "source": src + "wkv6.cu",
        "replaces": rep + "wkv6.py:75", "launches": launches["rwkv"]["K7"],
        "max_abs_err": c["max_abs_err"],
        "ms": c["ms"], "kernel_ms": c["ms"], "plain_ms": c["plain_ms"],
        "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
        "library_ms": None, "host_us": c["host_us"],
        "geometry": c["geometry"],
        "checks": [{k: x[k] for k in ("geometry", "max_abs_err", "tol",
                                      "tol_used", "parts")}
                   for x in k7_checks]})
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    t0 = time.monotonic()
    main()
    print(f"chip_smoke: done in {time.monotonic() - t0:.1f} s",
          file=sys.stderr)
