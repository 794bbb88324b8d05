"""Serving scenarios run by every rank of a spawned process group
(``repro_torch.launch.mesh.run_spmd``) for tests/test_torch_multidevice.py.

Each rank runs the same program: the unsharded engine (``mesh=None``)
and the engine on a serving mesh, on the same weights, requests and
seeds; ``run`` returns, per scenario, what the tests assert on (rank
0's tokens, and per-rank facts such as cache shapes and weight bytes).
The module imports torch, numpy and the port only: the spawned ranks
never import JAX.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.convert import from_reference
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as TS
from repro_torch.inference.engine import Engine
from repro_torch.inference.scheduler import ContinuousEngine, Request
from repro_torch.inference.telemetry import Telemetry
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import ssm
from repro_torch.models.transformer import (attn_caches, init_cache,
                                            init_model, set_cross_gates,
                                            unstacked_cache_specs)

MAX_LEN = 96
SLOTS = 8
DEV = dict(device="cpu")
# the archs whose cross-attention and RWKV6 layers take tensor parallelism
XARCHS = ("whisper_small", "llama_3_2_vision", "rwkv6_3b")
# the archs whose Mamba and latent-attention layers (with shared experts)
# take tensor parallelism
MARCHS = ("jamba_1_5_large", "deepseek_v3")
# every cross gate (init 0: tanh(0) = 0 keeps the encoder and the image
# out of the logits)
XGATE = 0.5


def requests(vocab, shapes, seed=0, greedy=True, temps=None):
    rng = np.random.default_rng(seed)
    out = [Request(rid, rng.integers(1, vocab - 4, size=(n,)).astype(
        np.int32), k, greedy=greedy, seed=rid * 7 + 1)
        for rid, (n, k) in enumerate(shapes)]
    for r, t in zip(out, temps or ()):
        r.temperature = t
    return out


def model(arch, seed=0):
    cfg = reduced(get_config(arch))
    return cfg, init_model(seed, cfg, **DEV)


def xmodel(arch, seed=0):
    """``model`` with every cross gate at ``XGATE``."""
    cfg, params = model(arch, seed)
    return cfg, set_cross_gates(params, XGATE)


def extras_of(cfg, batch, seed=3):
    """The second input of an encoder-decoder (``enc_x``) or a
    cross-attention arch (``img``), (batch, T, d) from ``seed``; {} for
    other archs."""
    rng = np.random.default_rng(seed)
    key, t = (("enc_x", cfg.enc_seq_len) if cfg.enc_dec else
              ("img", cfg.n_image_tokens) if cfg.cross_attn_period else
              (None, 0))
    if key is None:
        return {}
    return {key: rng.standard_normal((batch, t, cfg.d_model)).astype(
        np.float32)}


def pair(cfg, params, mesh, device="cpu", **kw):
    """(unsharded, sharded) continuous engines of one configuration."""
    kw = {"slots": SLOTS, "max_len": MAX_LEN, "seg_len": 4, **kw}
    return (ContinuousEngine(cfg, params, device=device, **kw),
            ContinuousEngine(cfg, params, mesh=mesh, device=device, **kw))


def both(plain, sharded, mk):
    return plain.run(mk()), sharded.run(mk())


def generate_both(cfg, params, mesh, batch=8, n_new=12, device="cpu",
                  extras=None, **kw):
    """Static generate, greedy and sampled: {greedy: (plain, sharded)}.
    ``extras``: an encoder-decoder's or cross-attention arch's second
    input."""
    plain = Engine(cfg, params, max_len=MAX_LEN, device=device, **kw)
    sharded = Engine(cfg, params, max_len=MAX_LEN, mesh=mesh, device=device,
                     **kw)
    prompts = np.random.default_rng(3).integers(
        1, cfg.vocab - 4, size=(batch, 24)).astype(np.int32)
    return {g: (plain.generate(prompts, n_new, greedy=g, seed=5,
                               extras=extras).tokens,
                sharded.generate(prompts, n_new, greedy=g, seed=5,
                                 extras=extras).tokens)
            for g in (True, False)}, sharded


SAMPLED = dict(shapes=[(20, 6), (33, 8), (11, 4), (26, 9)],
               temps=(1.0, 0.7, 1.6, 1.0))


# -- data parallelism: a ("data",) mesh of every rank -------------------------


def dp_scenarios(rank):
    out = {}
    mesh = make_serving_mesh()
    cfg, params = model("stablelm_3b")
    plain, sharded = pair(cfg, params, mesh)
    leaf = next(attn_caches(sharded._caches))["k"]
    out["resident"] = (tuple(leaf.shape), sharded._lo, sharded._hi)
    out["layout"] = _cache_layout(sharded, mesh)
    shapes = [(20, 5), (33, 9), (7, 1), (40, 12), (12, 6), (25, 3),
              (18, 8), (51, 4), (9, 7), (28, 2)]
    out["chunked"] = both(plain, sharded,
                          lambda: requests(cfg.vocab, shapes))
    out["chunked_stats"] = (plain.chunked, sharded.chunked,
                            sharded.stats["chunks"])
    out["sampled"] = both(plain, sharded, lambda: requests(
        cfg.vocab, SAMPLED["shapes"], seed=5, greedy=False,
        temps=SAMPLED["temps"]))
    solo = Engine(cfg, params, max_len=MAX_LEN, **DEV)
    reqs = requests(cfg.vocab, [(24, 6), (40, 9), (15, 5)], seed=17)
    got = sharded.run(list(reqs))
    out["solo"] = (got, {r.rid: solo.generate(r.prompt[None], r.n_new,
                                              seed=r.seed).tokens[0]
                         for r in reqs})
    p, s = pair(cfg, params, mesh, chunked_prefill=False)
    out["blocking"] = both(p, s, lambda: requests(
        cfg.vocab, [(20, 5), (33, 9), (12, 6), (25, 3)], seed=31))
    out["blocking_chunked"] = s.chunked
    p, s = pair(cfg, params, mesh, spec=3)
    out["spec"] = both(p, s, lambda: requests(
        cfg.vocab, [(20, 8), (33, 12), (12, 6), (40, 10), (18, 5)],
        seed=11))
    out["spec_stats"] = (s.spec, s.stats["spec_rounds"])
    out["generate"], _ = generate_both(cfg, params, mesh)
    tel = Telemetry(sample_every=0)
    s = ContinuousEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                         seg_len=4, mesh=mesh, telemetry=tel, **DEV)
    s.run(requests(cfg.vocab, [(5, 3), (37, 6), (60, 9), (14, 2)], seed=5))
    first = tel.compile_count("segment")
    s.reset()
    s.run(requests(cfg.vocab, [(9, 2), (41, 4)], seed=6))
    out["compiles"] = (first, tel.compile_count("segment"))

    out["nan"] = _sharded_nan(cfg, params, mesh)

    ycfg, yparams = model("yi_6b")
    p, s = pair(ycfg, yparams, mesh, long_context=True, dsa_mode="block")
    out["dsa_long"] = both(p, s, lambda: requests(
        ycfg.vocab, [(48, 8), (21, 12), (65, 5), (30, 10), (17, 7)],
        seed=21))
    out["paged"] = _paged(ycfg, yparams, mesh)
    return out


def _sharded_nan(cfg, params, mesh):
    """The reference's sharded NaN isolation: request 1's logits row goes
    NaN after its first segment on a dp-2 engine of 2 slots (one a rank);
    returns (unsharded fault-free tokens, sharded tokens, failed count,
    whether the engine drained clean)."""
    from repro_torch.inference.faults import Fault, FaultInjector
    shapes = [(24, 10), (26, 12), (12, 6)]
    p, s = pair(cfg, params, mesh, slots=2)
    base = p.run(requests(cfg.vocab, shapes))
    s.injector = FaultInjector(Fault("nan_logits", rid=1, after=1))
    got = s.run(requests(cfg.vocab, shapes))
    clean = (all(x is None for x in s._slot) and not s._reserved
             and s._pf is None and not s._live and not s.queue)
    return base, got, s.stats["failed"], clean


def _paged(cfg, params, mesh):
    """Paged serving with a copy-on-write prefix group, two waves (a
    registry miss, then hits)."""
    p, s = pair(cfg, params, mesh, long_context=True, dsa_mode="block",
                chunk_tokens=16, paged=True)
    rng = np.random.default_rng(41)
    sys_p = rng.integers(1, cfg.vocab - 4, size=(40,)).astype(np.int32)
    shared = [np.concatenate([sys_p, rng.integers(
        1, cfg.vocab - 4, size=(tail,)).astype(np.int32)])
        for tail in (8, 15, 3)]

    def mk(base=0):
        reqs = requests(cfg.vocab, [(48, 8), (21, 12), (65, 5), (30, 10)],
                        seed=43)
        for r in reqs:
            r.rid += base
        reqs += [Request(base + 10 + j, q, 5 + j, seed=j * 7 + 1,
                         prefix_len=40) for j, q in enumerate(shared)]
        return reqs

    waves = [both(p, s, mk), both(p, s, lambda: mk(100))]
    return waves, (s.stats["prefix_tokens_reused"], s.pool.available(),
                   s.pool_pages - 1 - 40 // s._page_rows)


def _cache_layout(s, mesh):
    """(the shape of every leaf of the continuous engine ``s``'s resident
    cache on this rank, the shape ``unstacked_cache_specs`` resolves it
    to under the engine's rules): the whole cache is laid out on the
    meta device, never allocated."""
    e = s.engine
    whole = init_cache(e.cfg, s.slots, s.max_len, e.decode_flags,
                       dtype=e.cache_dtype, device="meta",
                       pages=s.pool_pages if s.paged else None)
    specs = unstacked_cache_specs(e.cfg, whole)

    def local(t, log):
        spec = TS.resolve_spec(tuple(t.shape), tuple(log), e.shard_rules,
                               mesh)
        return tuple(TS.local_shard(t, spec, mesh).shape)
    return (TS._map2(lambda t, log: tuple(t.shape), s._caches, specs),
            TS._map2(local, whole, specs))


# -- tensor parallelism: a (1, 2) mesh ----------------------------------------


def tp_scenarios(rank):
    out = {}
    cfg, params = model("stablelm_3b")
    mesh = make_serving_mesh(dp=1, tp=2, cfg=cfg)
    out.update(_tp_common(cfg, params, mesh, rank))
    plain, sharded = pair(cfg, params, mesh)
    out["sampled"] = both(plain, sharded, lambda: requests(
        cfg.vocab, SAMPLED["shapes"], seed=29, greedy=False,
        temps=SAMPLED["temps"]))
    out["budget"] = _budget(cfg, params, mesh)
    streamed = Engine(cfg, functools.partial(init_model, 0, cfg, **DEV),
                      max_len=MAX_LEN, mesh=mesh, **DEV)
    whole = Engine(cfg, params, max_len=MAX_LEN, mesh=mesh, **DEV)
    prompts = np.random.default_rng(9).integers(
        1, cfg.vocab - 4, size=(4, 24)).astype(np.int32)
    out["streamed"] = (
        [tuple(t.shape) for t in _leaves(streamed.params)],
        all(torch.equal(a, b) for a, b in zip(_leaves(streamed.params),
                                              _leaves(whole.params))),
        streamed.generate(prompts, 8).tokens,
        whole.generate(prompts, 8).tokens)

    mcfg, mparams = model("mixtral_8x22b")
    mmesh = make_serving_mesh(dp=1, tp=2, cfg=mcfg)
    out["mixtral_generate"], eng = generate_both(
        mcfg, mparams, mmesh, batch=2, n_new=8, long_context=True,
        dsa_mode="kernel")
    out["mixtral_experts"] = (
        eng.params["groups"][0]["b0"]["mlp"]["w1"].shape[0],
        mcfg.moe.num_experts)
    p, s = pair(mcfg, mparams, mmesh, slots=2)
    out["mixtral_continuous"] = both(p, s, lambda: requests(
        mcfg.vocab, [(20, 6), (33, 5), (12, 4)], seed=13))

    ycfg, yparams = model("yi_6b")
    ymesh = make_serving_mesh(dp=1, tp=2, cfg=ycfg)
    p, s = pair(ycfg, yparams, ymesh, long_context=True, dsa_mode="kernel",
                kv_quant="int8", select_dtype="int8", paged=True)
    out["int8"] = both(p, s, lambda: requests(
        ycfg.vocab, [(48, 8), (21, 12), (65, 5), (30, 10)], seed=47))
    k = next(attn_caches(s._caches))
    out["int8_cache"] = (k["k"].dtype, tuple(k["k"].shape),
                         tuple(k["k_s"].shape))
    out["int8_layout"] = _cache_layout(s, ymesh)
    for arch in ("h2o_danube_1_8b", "qwen1_5_110b"):
        acfg, aparams = model(arch)
        amesh = make_serving_mesh(dp=1, tp=2, cfg=acfg)
        gen, _ = generate_both(acfg, aparams, amesh, batch=2, n_new=8,
                               long_context=True, dsa_mode="kernel")
        p, s = pair(acfg, aparams, amesh, slots=2)
        out[arch] = gen, both(p, s, lambda: requests(
            acfg.vocab, [(70, 6), (33, 5), (12, 4)], seed=17))
    jcfg, jparams = model("jamba_1_5_large")
    out["jamba_tp"] = Engine(jcfg, jparams, mesh=ymesh, **DEV).tp
    for arch in XARCHS + MARCHS:
        xcfg, xparams = xmodel(arch)
        out["x", arch] = _xarch(xcfg, xparams,
                                make_serving_mesh(dp=1, tp=2, cfg=xcfg))
    out["mamba_weights"] = _mamba_weights(jcfg, jparams, ymesh, rank)
    return out


def _mamba_weights(cfg, params, mesh, rank):
    """A jamba rank's Mamba leaves at tp 2 against the whole ones:
    ``in_proj`` is its channels of both halves [x_r | z_r], ``x_proj``
    its rows with the whole width's dt rank, and the ``h`` and ``conv``
    caches its channels."""
    eng = Engine(cfg, params, max_len=MAX_LEN, mesh=mesh, **DEV)
    got = eng.params["groups"][0]["b0"]["attn"]
    want = params["groups"][0]["b0"]["attn"]
    mi = cfg.d_model * cfg.mamba.expand
    w = mi // 2
    mine = [*range(rank * w, (rank + 1) * w)]
    cache = eng.resident_cache(2)["groups"][0]["b0"]["attn"]
    return dict(
        in_proj=torch.equal(got["in_proj"], want["in_proj"][
            :, mine + [mi + c for c in mine]]),
        x_proj=(tuple(got["x_proj"].shape), torch.equal(
            got["x_proj"], want["x_proj"][mine])),
        dt_rank=ssm.dt_rank(eng.mcfg), d_inner=ssm.d_inner(eng.mcfg),
        cache=(tuple(cache["h"].shape), tuple(cache["conv"].shape)))


def _xarch(cfg, params, mesh):
    """Cross-attention and RWKV6 archs at tp 2: static generate greedy
    and sampled with the second input, the continuous engine (blocking
    admission, no second input), its resident cache against the resolved
    specs, the prefill's last-row logits against the unsharded ones, and
    the collectives of a prefill and of one decode step against the
    budget."""
    out = {}
    b = 4
    extras = extras_of(cfg, b)
    out["generate"], eng = generate_both(cfg, params, mesh, batch=b,
                                         n_new=8, extras=extras)
    p, s = pair(cfg, params, mesh, slots=2)
    out["continuous"] = both(p, s, lambda: requests(
        cfg.vocab, [(20, 6), (33, 5), (12, 4)], seed=13))
    out["layout"] = _cache_layout(s, mesh)
    prompts = np.random.default_rng(7).integers(
        1, cfg.vocab - 4, size=(b, 24)).astype(np.int32)
    plain = Engine(cfg, params, max_len=MAX_LEN, **DEV)
    want = plain.prefill(prompts, extras=extras)[0]
    before = C.snapshot()
    got, caches, _ = eng.prefill(prompts, caches=eng.resident_cache(b),
                                 extras=extras)
    prefill = C.count_collectives(before, "model")
    out["logits"] = float((got - want).abs().max() / want.abs().max())
    step = eng.scan_step(b)
    before = C.snapshot()
    with torch.inference_mode():
        step(got[:, -1].argmax(-1, keepdim=True))
    out["budget"] = (prefill, C.count_collectives(before, "model"),
                     TS.tp_decode_all_reduces(eng.mcfg))
    full = sum(t.numel() * t.element_size() for t in _leaves(params))
    out["weights"] = (eng.tp, eng.weight_bytes_per_device(), full)
    return out


def _tp_common(cfg, params, mesh, rank):
    """The scenarios every tensor-parallel grid runs: weights on the
    "model" axis, chunked continuous serving, static generate."""
    out = {}
    eng = Engine(cfg, params, max_len=MAX_LEN, mesh=mesh, **DEV)
    full = sum(t.numel() * t.element_size()
               for t in _leaves(params))
    out["weights"] = (eng.tp, eng.weight_bytes_per_device(), full,
                      tuple(eng.params["groups"][0]["b0"]["attn"]["wq"]
                            .shape))
    plain, sharded = pair(cfg, params, mesh)
    out["chunked"] = both(plain, sharded, lambda: requests(
        cfg.vocab, [(20, 5), (33, 9), (7, 1), (40, 12), (12, 6), (25, 3)],
        seed=19))
    out["chunked_stats"] = (sharded.engine.tp, sharded.stats["chunks"])
    out["generate"], _ = generate_both(cfg, params, mesh)
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _budget(cfg, params, mesh):
    """Collectives of one decode segment at seg_len 4 and 8, all slots
    busy: {seg_len: (counts over "model", counts over "data", steps)}."""
    out = {}
    for seg in (4, 8):
        eng = ContinuousEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                               seg_len=seg, **DEV, mesh=mesh)
        for r in requests(cfg.vocab, [(16, 30)] * SLOTS, seed=3):
            eng.submit(r)
        results = []
        while eng._pf is not None or eng.queue:
            eng.admit_ready(lambda: 0.0, results)
            eng.step_prefill(lambda: 0.0, results)
        steps0 = eng.stats["decode_steps"]
        before = C.snapshot()
        eng.run_segment(lambda: 0.0, results)
        out[seg] = (C.count_collectives(before, "model"),
                    C.count_collectives(before, "data"),
                    eng.stats["decode_steps"] - steps0)
    return out


# -- data x tensor parallelism: (2, 2) and (1, 4) meshes of four ranks -------


def dp_tp_scenarios(rank, ref=None):
    out = {}
    cfg, params = model("stablelm_3b")
    for grid in ((2, 2), (1, 4)):
        mesh = make_serving_mesh(dp=grid[0], tp=grid[1], cfg=cfg)
        out[grid] = _tp_common(cfg, params, mesh, rank)
    mesh = make_serving_mesh(dp=2, tp=2, cfg=cfg)
    for mode in ("block", "kernel"):
        p, s = pair(cfg, params, mesh, dsa_mode=mode)
        out[("dsa", mode)] = both(p, s, lambda: requests(
            cfg.vocab, [(20, 6), (33, 9), (14, 4), (27, 8)], seed=23))
    p, s = pair(cfg, params, mesh, chunked_prefill=False)
    out["blocking"] = both(p, s, lambda: requests(
        cfg.vocab, [(20, 5), (33, 9), (12, 6), (25, 3)], seed=37))
    out["blocking_chunked"] = s.chunked
    p, s = pair(cfg, params, mesh, paged=True)
    out["paged"] = both(p, s, lambda: requests(
        cfg.vocab, [(20, 6), (33, 9), (14, 4), (27, 8)], seed=41))
    out["layout"] = _cache_layout(s, mesh)
    tel = Telemetry(sample_every=0)
    s = ContinuousEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                         seg_len=4, mesh=mesh, telemetry=tel, **DEV)
    s.run(requests(cfg.vocab, [(5, 3), (37, 6), (60, 9), (14, 2)], seed=5))
    first = tel.compile_count("segment")
    s.reset()
    s.run(requests(cfg.vocab, [(9, 2), (41, 4)], seed=6))
    out["compiles"] = (first, tel.compile_count("segment"))

    # tp 4 above reduced yi_6b's 2 KV heads: each rank one query head on
    # the one KV head of its group
    ycfg, yparams = model("yi_6b")
    kv_mesh = make_serving_mesh(dp=1, tp=4, cfg=ycfg)
    out["kv_generate"], eng = generate_both(ycfg, yparams, kv_mesh,
                                            n_new=10)
    attn = eng.params["groups"][0]["b0"]["attn"]
    out["kv_weights"] = (eng.tp, eng.mcfg.n_heads, eng.mcfg.n_kv_heads,
                         tuple(attn["wk"].shape), torch.equal(
                             attn["wk"], yparams["groups"][0]["b0"]["attn"]
                             ["wk"][:, rank // 2 * 16:(rank // 2 + 1) * 16]))
    p, s = pair(ycfg, yparams, kv_mesh)
    out["kv_continuous"] = both(p, s, lambda: requests(
        ycfg.vocab, [(20, 6), (33, 9), (14, 4), (27, 8)], seed=43))
    # 2 query heads on 2 KV heads: tp 4 divides neither
    fcfg = dataclasses.replace(ycfg, n_heads=2, n_kv_heads=2, head_dim=32)
    fparams = init_model(0, fcfg, **DEV)
    fallback = make_serving_mesh(dp=1, tp=4)      # no cfg: not validated
    out["fallback"] = generate_both(fcfg, fparams, fallback, n_new=10)[0]
    eng = Engine(fcfg, fparams, max_len=MAX_LEN, mesh=fallback, **DEV)
    out["fallback_weights"] = (
        eng.tp, eng.weight_bytes_per_device(),
        sum(t.numel() * t.element_size() for t in _leaves(fparams)))
    # cross-attention, RWKV6, Mamba and MLA at dp 2 x tp 2, and
    # llama_3_2_vision at tp 4 above its 2 KV heads in both attentions
    for arch in XARCHS + MARCHS:
        xcfg, xparams = xmodel(arch)
        xmesh = make_serving_mesh(dp=2, tp=2, cfg=xcfg)
        out["x", arch] = generate_both(xcfg, xparams, xmesh, batch=4,
                                       n_new=8, extras=extras_of(xcfg, 4))[0]
    vcfg, vparams = xmodel("llama_3_2_vision")
    vmesh = make_serving_mesh(dp=1, tp=4, cfg=vcfg)
    out["x_kv_generate"], eng = generate_both(
        vcfg, vparams, vmesh, batch=4, n_new=8, extras=extras_of(vcfg, 4))
    sub = eng.params["groups"][0]["b3"]
    head = slice(rank // 2 * 16, (rank // 2 + 1) * 16)
    out["x_kv_weights"] = (
        eng.tp, eng.mcfg.n_heads, eng.mcfg.n_kv_heads,
        tuple(sub["xattn"]["wk"].shape), all(
            torch.equal(sub[a]["wk"], vparams["groups"][0]["b3"][a]["wk"][
                :, head]) for a in ("attn", "xattn")))
    p, s = pair(vcfg, vparams, vmesh, slots=2)
    out["x_kv_continuous"] = both(p, s, lambda: requests(
        vcfg.vocab, [(20, 6), (33, 5), (12, 4)], seed=13))
    # explicit tensor-parallel rules on a tp that the heads do not divide
    try:
        Engine(fcfg, fparams, max_len=MAX_LEN, mesh=fallback,
               shard_rules=TS.make_serving_rules(tp=True), **DEV)
        out["explicit_rules"] = None
    except ValueError as e:
        out["explicit_rules"] = str(e)
    if ref is not None:
        out["reference"] = _reference(ref, mesh)
        out["x_reference"] = {
            arch: _x_reference(arch, xp, ref, mesh)
            for arch, xp in ref["x_params"].items()}
        eng = Engine(ycfg, from_reference(ref["kv_params"], device="cpu"),
                     max_len=MAX_LEN, mesh=kv_mesh, **DEV)
        out["reference_kv"] = (eng.tp, eng.generate(
            ref["prompts"], ref["n_new"], seed=5).tokens)
    return out


def _reference(ref, mesh):
    """The port at dp 2 x tp 2 on the reference's weights (numpy, through
    ``repro_torch.convert``): static generate and continuous serving."""
    cfg = reduced(get_config(ref["arch"]))
    params = from_reference(ref["params"], device="cpu")
    eng = Engine(cfg, params, max_len=MAX_LEN, mesh=mesh, **DEV)
    gen = eng.generate(ref["prompts"], ref["n_new"], seed=5).tokens
    s = ContinuousEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                         seg_len=4, mesh=mesh, **DEV)
    cont = s.run(requests(cfg.vocab, ref["shapes"], seed=ref["seed"]))
    return gen, cont


def _x_reference(arch, xparams, ref, mesh):
    """The port at dp 2 x tp 2 on the reference's weights of ``arch``
    (its cross gates at ``XGATE``): static greedy generate with the
    second input."""
    cfg = reduced(get_config(arch))
    eng = Engine(cfg, from_reference(xparams, device="cpu"), max_len=MAX_LEN,
                 mesh=mesh, **DEV)
    return eng.generate(ref["prompts"][:4], ref["n_new"], seed=5,
                        extras=extras_of(cfg, 4)).tokens


def run(rank, group, ref=None):
    """Every scenario of ``group`` ("dp", "tp" or "dp_tp") on this
    rank."""
    torch.manual_seed(0)
    if group == "dp":
        return dp_scenarios(rank)
    if group == "tp":
        return tp_scenarios(rank)
    return dp_tp_scenarios(rank, ref)


# -- on the card (tests/test_torch_cuda.py) ------------------------------------


def card_tp2(rank, device="cuda"):
    """tp 2 as two gloo processes on one card, reduced yi_6b (f32, kernel
    DSA): static generate greedy and sampled, and the continuous engine
    chunked then paged with int8 K/V, against the unsharded engines on
    the same card (graphed; the gloo engine decodes eagerly)."""
    dev = torch.device(device)
    cfg = reduced(get_config("yi_6b"))
    params = init_model(0, cfg, device=dev)
    mesh = make_serving_mesh(dp=1, tp=2, cfg=cfg)
    kw = dict(long_context=True, dsa_mode="kernel")
    out = {}
    out["generate"], eng = generate_both(cfg, params, mesh, device=dev,
                                         **kw)
    out["graphs"] = eng.graphs is None
    shapes = [(48, 8), (21, 12), (65, 5), (30, 10)]
    for name, extra in (("chunked", {}),
                        ("paged int8", dict(paged=True, kv_quant="int8",
                                            select_dtype="int8"))):
        p, s = pair(cfg, params, mesh, device=dev, **kw, **extra)
        out[name] = both(p, s, lambda: requests(cfg.vocab, shapes, seed=7))
    return out


def card_nccl1(rank, device="cuda"):
    """NCCL at world size 1, a ("data", "model") mesh of (1, 1): the
    sharded code path with every collective, reduced yi_6b (f32, kernel
    DSA).  The graphed decode step against the eager step on a copy of
    the cache (logits and every cache leaf, bit for bit), the tokens
    against the unsharded engine's, and the collectives of a generate
    against (steps + 1) x the budget."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import decode_step
    from repro_torch.tree import map_tree
    dev = torch.device(device)
    cfg = reduced(get_config("yi_6b"))
    params = init_model(0, cfg, device=dev)
    mesh = make_host_mesh(model=1)
    kw = dict(long_context=True, dsa_mode="kernel")
    out = {}
    out["generate"], eng = generate_both(cfg, params, mesh, device=dev,
                                         **kw)
    prompts = np.random.default_rng(4).integers(
        1, cfg.vocab - 4, size=(2, 40)).astype(np.int32)
    b = prompts.shape[0]
    step = eng.scan_step(b)                       # capture before prefill
    last, res, _ = eng.prefill(prompts, caches=eng.resident_cache(b))
    same = True
    with torch.inference_mode():
        twin = map_tree(lambda t: t.clone(), res)
        tok = last[:, -1].argmax(-1, keepdim=True)
        for _ in range(4):
            g = step(tok).clone()
            e = decode_step(eng.params, eng.mcfg, eng.decode_flags, tok,
                            twin)[0]
            same &= bool(torch.equal(g, e))
            tok = g[:, -1].argmax(-1, keepdim=True)
        for a, c in zip(attn_caches(res), attn_caches(twin)):
            same &= all(bool(torch.equal(a[k], c[k])) for k in a)
    out["graph_bits"] = same
    out["captured"] = eng.graphs is not None and eng.graphs.captures > 0
    before = C.snapshot()
    res = eng.generate(prompts, 9)
    out["counts"] = (C.count_collectives(before, "model"),
                     C.count_collectives(before, "data"),
                     res.decode_steps, cfg.n_layers)
    return out


def fail_rank(rank, which):
    """Rank ``which`` raises; the others wait for it at a barrier."""
    import torch.distributed as dist
    if rank == which:
        raise ValueError(f"rank {rank} fails on purpose")
    dist.barrier()
    return rank
