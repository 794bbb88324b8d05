"""Times the collectives of FSDP training when two processes share one
card over gloo (``chip_smoke.py`` phase 22): every CUDA tensor is staged
through host memory.  On a machine with a card:

    python3 scripts/gloo_staging.py

Two gloo ranks on card 0 gather and reduce-scatter the data-sharded
leaves of one yi_6b layer in bf16 (wq, wk, wv, wo, w1, w3, w2 and the
predictor's P: 179 M parameters whole, half a rank) over "data", and
rank 0 prints the median ms of 3 rounds of: the port's
``collectives.all_gather`` and ``reduce_scatter`` (as ``fsdp_gather``
calls them), and their parts: the device-to-host and host-to-device
copies (pageable and pinned), gloo's all-gather of host tensors into a new
buffer and into a reused (pageable or pinned) one, its reduce-scatter
of host tensors (bf16 and f32), a reduce-scatter made of an all-gather
and a sum on the card, gloo's all-to-all of the whole leaves (the
exchange of halves a reduce-scatter of two ranks needs), and the
all-gather and the all-to-all split over 2, 4 and 8 groups of the same
two ranks, all chunks in flight at once.  The card's name and power limit come first.
"""
from __future__ import annotations

import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

# (shard shape of a (2, 1) mesh, the gathered dim) of one yi_6b layer
LEAVES = [((2048, 4096), 0), ((2048, 512), 0), ((2048, 512), 0),
          ((4096, 2048), 1), ((2048, 11008), 0), ((2048, 11008), 0),
          ((11008, 2048), 1), ((2048, 1024), 0)]


def _ms(torch, fn, rounds=3):
    """Median ms of ``rounds`` calls, or the error a call raised."""
    out = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            fn()
        except RuntimeError as e:
            return f"error: {str(e).splitlines()[0][:120]}"
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return statistics.median(out)


def rank(r: int) -> dict:
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.mesh import make_host_mesh
    dev = torch.device("cuda", torch.cuda.current_device())
    g = C.axis_group(make_host_mesh(model=1), "data")
    xs = [torch.randn(s, device=dev).to(torch.bfloat16) for s, _ in LEAVES]
    full = [torch.cat([x, x], d) for x, (_, d) in zip(xs, LEAVES)]
    host = [x.cpu() for x in xs]
    hfull = [x.cpu() for x in full]
    pin = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True) for x in xs]
    out = {"threads": torch.get_num_threads()}

    def each(fn, args):
        args = list(args)
        return lambda: [fn(*a) for a in args]

    out["all_gather (port)"] = _ms(torch, each(
        lambda x, ld: C.all_gather(x, g, ld[1]), zip(xs, LEAVES)))
    out["reduce_scatter (port)"] = _ms(torch, each(
        lambda x, ld: C.reduce_scatter(x, g, ld[1]), zip(full, LEAVES)))
    out["D2H pageable (shards)"] = _ms(torch, each(lambda x: x.cpu(),
                                                   [(x,) for x in xs]))
    out["D2H pinned (shards)"] = _ms(torch, each(
        lambda x, p: p.copy_(x), zip(xs, pin)))
    out["H2D pageable (wholes)"] = _ms(torch, each(
        lambda h: h.to(dev), [(h,) for h in hfull]))

    def gather_host(h, flat=None):
        if flat is None:
            flat = torch.empty((2 * h.numel(),), dtype=h.dtype)
        dist.all_gather_into_tensor(flat, h.reshape(-1), group=g.group)
    out["gloo all_gather, host bf16, new buffer"] = _ms(torch, each(
        gather_host, [(h,) for h in host]))
    flats = [torch.empty((2 * h.numel(),), dtype=h.dtype) for h in host]
    for f in flats:
        f.zero_()
    out["gloo all_gather, host bf16, reused buffer"] = _ms(torch, each(
        gather_host, zip(host, flats)))
    pflats = [torch.zeros((2 * h.numel(),), dtype=h.dtype, pin_memory=True)
              for h in host]
    out["gloo all_gather, pinned bf16, reused buffer"] = _ms(torch, each(
        gather_host, zip(pin, pflats)))
    out["H2D pinned (wholes)"] = _ms(torch, each(
        lambda h: h.to(dev, non_blocking=True), [(h,) for h in pflats]))

    def rs_host(src, o):
        dist.reduce_scatter_tensor(o, src, group=g.group)
    for dt in (torch.bfloat16, torch.float32):
        srcs = [h.reshape(-1).to(dt) for h in hfull]
        outs = [torch.zeros((x.numel() // 2,), dtype=dt) for x in srcs]
        out[f"gloo reduce_scatter, host {str(dt)[6:]}, reused buffers"] = \
            _ms(torch, each(rs_host, zip(srcs, outs)))

    def rs_by_gather(x, d):
        both = C.all_gather(x.movedim(d, 0).contiguous(), g, 0)
        return (both[:x.shape[d]] + both[x.shape[d]:]).narrow(
            0, g.rank * (x.shape[d] // 2), x.shape[d] // 2)
    out["reduce_scatter as gather + card sum"] = _ms(torch, each(
        rs_by_gather, [(x, d) for x, (_, d) in zip(full, LEAVES)]))
    # an exchange of halves (all_to_all) and a sum on the card
    a2a = [(torch.zeros(h.numel(), dtype=h.dtype, pin_memory=True),
             torch.zeros(h.numel(), dtype=h.dtype, pin_memory=True))
           for h in hfull]
    out["gloo all_to_all, pinned bf16 (wholes)"] = _ms(torch, each(
        lambda i, o: dist.all_to_all_single(o, i, group=g.group), a2a))
    # k groups over the same two ranks, each a chunk, all in flight
    for k in (2, 4, 8):
        lanes = [dist.new_group([0, 1]) for _ in range(k)]

        def gather_lanes(h, flat):
            n = h.numel() // k
            src, dst = h.reshape(-1), flat.view(2, -1)
            outs = [torch.empty((2 * n,), dtype=h.dtype, pin_memory=True)
                    for _ in range(k)]
            works = [dist.all_gather_into_tensor(
                outs[j], src[j * n:(j + 1) * n], group=lanes[j],
                async_op=True) for j in range(k)]
            for w in works:
                w.wait()
            for j in range(k):
                dst[:, j * n:(j + 1) * n].copy_(outs[j].view(2, n))
        out[f"gloo all_gather, pinned bf16, {k} groups"] = _ms(
            torch, each(gather_lanes, zip(pin, pflats)))

        def a2a_lanes(i, o):
            n = i.numel() // k
            works = [dist.all_to_all_single(
                o[j * n:(j + 1) * n], i[j * n:(j + 1) * n], group=lanes[j],
                async_op=True) for j in range(k)]
            for w in works:
                w.wait()
        out[f"gloo all_to_all, pinned bf16 (wholes), {k} groups"] = _ms(
            torch, each(a2a_lanes, a2a))
    return out


def main() -> None:
    import torch
    from repro_torch.launch.mesh import run_spmd
    if not torch.cuda.is_available():
        sys.exit("no card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)
    n = sum(a * b for (a, b), _ in LEAVES)
    print(f"one yi_6b layer's data-sharded leaves, bf16: {n:,} parameters "
          f"a rank ({2 * n / 2**20:.0f} MiB), {2 * n:,} whole", flush=True)
    res = run_spmd(rank, 2, store_dir=tempfile.mkdtemp(), backend="gloo",
                   device_ids=[0, 0], timeout_s=600)[0]
    for k, v in res.items():
        print(f"  {k}: " + (v if isinstance(v, str) else f"{v:.1f}"
                            + ("" if k == "threads" else " ms")), flush=True)


if __name__ == "__main__":
    main()
