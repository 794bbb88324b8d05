#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (exit code 1, no result line) if it
fails:

  1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
  2. build: nvcc compiles every kernel source of the checkout, in parallel;
  3. kernels: K1 (decode gather-attend) and K2 (block-sparse prefill)
     against their plain PyTorch versions on the same inputs, at a reduced
     geometry (hd 16, block 16, f32; K2 also bf16) and at yi_6b's full
     geometry (bf16, K1 also against the default f32 cache; and f32), each
     within a stated atol + rtol, with times (CUDA events, L2 flushed
     before each launch), the plain versions' and one PyTorch library
     call's times, and the least time the card could take;
  4. parity: yi_6b at full width with 2 layers in f32 serves the same
     greedy tokens with dsa_mode="kernel" as with the plain "block" path;
  5. the slice: ``repro_torch.launch.serve`` serves yi_6b at full width,
     all 32 layers in bf16, random weights from --seed, batch 4, prompt
     4096, 64 new tokens, DSA on the kernel path; the launch counters show
     K2 ran once per layer in prefill and K1 once per layer per decode step;
  6. profile: a torch.profiler trace of a few decode steps of the same
     model (wall time per step, device busy share, top kernels).

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


def bound(bytes_moved: float, flops: float, dtype: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- K1 -------------------------------------------------------------------------


def check_k1(torch, timer, *, b, hq, hkv, hd, s, bk, q_dt, c_dt, kv_len,
             nb, seed, timed):
    from repro_torch.core.masks import decode_block_topk_indices
    from repro_torch.kernels import dsa_decode as K1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def rnd(*shape, d):
        return torch.randn(shape, generator=gen, device=dev).to(dt[d])

    q = rnd(b, hq, 1, hd, d=q_dt)
    kc, vc = rnd(b, s, hkv, hd, d=c_dt), rnd(b, s, hkv, hd, d=c_dt)
    kvl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    n_kb = -(-s // bk)
    scores = torch.randn((b, n_kb), generator=gen, device=dev)
    idx, ok = decode_block_topk_indices(scores, min(nb, n_kb), kv_len=kvl,
                                        block_k=bk)
    args = (q, kc, vc, idx, ok, kvl)
    got = K1.dsa_decode_gather_attention(*args, block_k=bk)
    want = K1.dsa_decode_gather_attention_plain(*args, block_k=bk)
    torch.cuda.synchronize()
    res = dict(geometry=f"B{b} Hq{hq} Hkv{hkv} hd{hd} S{s} bk{bk} nb{nb} "
                        f"q {q_dt} cache {c_dt}",
               **compare(torch, got, want, q_dt))
    if not res["ok"]:
        fail(f"K1 disagrees with its plain version: {res}")
    if not timed:
        return res
    # bytes this call needs: q, the live selected K/V rows, out, indices
    kpos = idx.long()[:, :, None] * bk + torch.arange(bk, device=dev)
    live = (kpos < kvl[:, None, None]) & ok[:, :, None] & (kpos < s)
    rows = int(live.sum())
    c_el, q_el = kc.element_size(), q.element_size()
    nbytes = (2 * q.numel() * q_el + 2 * rows * hkv * hd * c_el
              + 2 * idx.numel() * 4 + kvl.numel() * 4)
    flops = 4.0 * rows * (hq // hkv) * hkv * hd
    work_dt = "bfloat16" if q_dt == c_dt == "bfloat16" else "float32"
    res["bound_ms"], res["bound_by"] = bound(nbytes, flops, work_dt)
    res["ms"] = timer(lambda: K1.dsa_decode_gather_attention(
        *args, block_k=bk), iters=50)
    res["host_us"] = timer.host_us(lambda: K1.dsa_decode_gather_attention(
        *args, block_k=bk))
    res["plain_ms"] = timer(lambda: K1.dsa_decode_gather_attention_plain(
        *args, block_k=bk), iters=10)
    # library yardstick: one SDPA call over the whole cache with the
    # selected rows as its mask (layouts prepared outside the timing)
    g = hq // hkv
    lib_dt = torch.float32 if work_dt == "float32" else torch.bfloat16
    kk = kc.transpose(1, 2).repeat_interleave(g, 1).to(lib_dt)
    vv = vc.transpose(1, 2).repeat_interleave(g, 1).to(lib_dt)
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
             timed):
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
        torch.randn((b, n, n), generator=gen, device=dev), nb)
    kw = dict(block_q=blk, block_k=blk, causal=True)
    got = K2.dsa_block_sparse_attention(q, k, v, idx, ok, **kw)
    want = K2.dsa_block_sparse_attention_plain(q, k, v, idx, ok, **kw)
    torch.cuda.synchronize()
    res = dict(geometry=f"B{b} Hq{hq} Hkv{hkv} hd{hd} L{l} block{blk} "
                        f"nb{nb} {dtype}",
               **compare(torch, got, want, dtype))
    if not res["ok"]:
        fail(f"K2 disagrees with its plain version: {res}")
    if not timed:
        return res
    # the work this call's selection needs: live causal (query, key) pairs
    # in the valid visited blocks; distinct selected K/V blocks read once
    qb = torch.arange(n, device=dev)[None, :, None]
    kb = idx.long()
    full = (kb < qb) & ok
    diag = (kb == qb) & ok
    pairs = int(full.sum()) * blk * blk + int(diag.sum()) * blk * (blk + 1) // 2
    used = torch.zeros((b, n), dtype=torch.bool, device=dev)
    used[torch.arange(b, device=dev)[:, None, None].expand_as(kb)[ok],
         kb[ok]] = True
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
    mask = tmask[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res["library_max_abs_err"] = float(
        (sdpa(q, kk, vv, attn_mask=mask).float() - want.float()).abs().max())
    res["library_ms"] = timer(lambda: sdpa(q, kk, vv, attn_mask=mask),
                              iters=3, warmup=1)
    del tmask, mask, kk, vv
    return res


# -- engine phases -----------------------------------------------------------


def parity_phase(torch, seed: int) -> dict:
    """yi_6b at full width, 2 layers, f32: kernel mode == block mode."""
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
    del params
    torch.cuda.empty_cache()
    return {"same_tokens": same}


def slice_phase(torch, seed: int) -> dict:
    """The main path: serve yi_6b at full width through the kernels."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import dsa_attention as K2
    from repro_torch.kernels import dsa_decode as K1
    from repro_torch.launch import serve
    n_layers = get_config("yi_6b").n_layers
    torch.cuda.reset_peak_memory_stats()
    K1.dsa_decode_gather_attention.launches = 0
    K2.dsa_block_sparse_attention.launches = 0
    res = serve.main(["--arch", "yi_6b", "--batch", "4", "--prompt-len",
                      "4096", "--new-tokens", "64", "--dsa", "--dsa-mode",
                      "kernel", "--seed", str(seed)])
    k1 = K1.dsa_decode_gather_attention.launches
    k2 = K2.dsa_block_sparse_attention.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    vocab = get_config("yi_6b").vocab
    print(f"slice: prefill {res.prefill_s * 1e3:.1f} ms, decode "
          f"{res.tokens_per_s:.1f} tok/s over {res.decode_steps} steps, "
          f"peak memory {peak:.2f} GiB, launches K2 {k2} K1 {k1}")
    if k2 != n_layers:
        fail(f"K2 launched {k2} times in prefill, expected {n_layers}")
    if k1 != n_layers * res.decode_steps or k1 == 0:
        fail(f"K1 launched {k1} times, expected {n_layers} x "
             f"{res.decode_steps}")
    tok = res.tokens
    if tok.shape != (4, 64) or tok.min() < 0 or tok.max() >= vocab:
        fail(f"bad tokens: shape {tok.shape}, range {tok.min()}..{tok.max()}")
    return {"prefill_ms": res.prefill_s * 1e3,
            "decode_tok_s": res.tokens_per_s, "decode_s": res.decode_s,
            "decode_steps": res.decode_steps, "peak_gib": peak,
            "launches": {"dsa_block_sparse_attention": k2,
                         "dsa_decode_gather_attention": k1}}


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


def profile_phase(torch, seed: int, steps: int = 8, traced: int = 2
                  ) -> dict:
    """Where the slice's time goes: host wall time of one prefill and of
    one decode step against the device time a torch.profiler trace sees,
    and the kernels that take most of it.  yi_6b at full width, bf16,
    batch 4, prompt 4096, DSA on the kernel path."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import get_config
    from repro_torch.inference.engine import Engine
    from repro_torch.models.transformer import decode_step, init_model
    cfg = get_config("yi_6b")
    eng = Engine(cfg, init_model(seed, cfg), max_len=4096 + 64 + 16,
                 long_context=True, dsa_mode="kernel")
    prompts = np.random.default_rng(seed).integers(
        1, cfg.vocab - 4, size=(4, 4096)).astype(np.int32)
    acts = [ProfilerActivity.CUDA]

    def run(caches, tok, steps=steps):
        for _ in range(steps):
            logits, caches = decode_step(eng.params, cfg, eng.decode_flags,
                                         tok, caches)
            tok = logits[:, -1].argmax(-1, keepdim=True)
        return caches, tok

    with torch.inference_mode():
        eng.prefill(prompts)                           # warm
        _, _, prefill_s = eng.prefill(prompts)
        with profile(activities=acts) as prof:
            last, caches, _ = eng.prefill(prompts)
        pre = _device_time(prof, "prefill", 1)
        tok = last[:, -1].argmax(-1, keepdim=True)
        caches, tok = run(caches, tok)                 # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        caches, tok = run(caches, tok)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / steps * 1e3
        with profile(activities=acts) as prof:
            caches, tok = run(caches, tok, traced)
            torch.cuda.synchronize()
        dec = _device_time(prof, "decode", traced)
    _print_profile("prefill", prefill_s * 1e3, *pre)
    _print_profile("decode step", step_ms, *dec)
    return {"prefill_ms": prefill_s * 1e3, "prefill_busy_ms": pre[0],
            "step_ms": step_ms, "step_busy_ms": dec[0]}


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
    for name, log in build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

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
    ]
    for name, checks in (("K1 dsa_decode", k1_checks),
                         ("K2 dsa_attention", k2_checks)):
        for c in checks:
            line = (f"{name} [{c['geometry']}]: max abs err "
                    f"{c['max_abs_err']:.3g} (atol {c['tol'][0]:g} + rtol "
                    f"{c['tol'][1]:g} x |plain|; {100 * c['tol_used']:.1f} % "
                    f"of it used)")
            if "ms" in c:
                line += (f", kernel {c['ms']:.4f} ms (host enqueue "
                         f"{c['host_us']:.1f} us), plain "
                         f"{c['plain_ms']:.4f} ms, library "
                         f"{c['library_ms']:.4f} ms, bound "
                         f"{c['bound_ms']:.4f} ms ({c['bound_by']})")
            print(line, flush=True)
    torch.cuda.empty_cache()

    parity_phase(torch, args.seed)
    launches = slice_phase(torch, args.seed)["launches"]
    torch.cuda.empty_cache()
    profile_phase(torch, args.seed)

    main_k1, main_k2 = k1_checks[2], k2_checks[2]
    kernels = []
    for name, src, rep, c, extra in (
            ("dsa_block_sparse_attention",
             "src/repro_torch/kernels/csrc/dsa_attention.cu",
             "src/repro/kernels/dsa_attention.py:77", main_k2, k2_checks),
            ("dsa_decode_gather_attention",
             "src/repro_torch/kernels/csrc/dsa_decode.cu",
             "src/repro/kernels/dsa_decode.py:185", main_k1, k1_checks)):
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name], "max_abs_err": c["max_abs_err"],
            "ms": c["ms"], "kernel_ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"], "host_us": c["host_us"],
            "geometry": c["geometry"],
            "checks": [{k: x[k] for k in ("geometry", "max_abs_err", "tol",
                                          "tol_used")}
                       for x in extra]})
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
