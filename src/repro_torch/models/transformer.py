"""Top-level model: embedding -> layer groups -> head.

Public API:
  init_model(seed, cfg, device=None, place=None) -> params
  forward(params, cfg, flags, tokens, caches, extras=None)
                                              -> (logits, caches)
  forward_train(params, cfg, flags, tokens, extras=None)
                                              -> (logits, aux)
  decode_step(params, cfg, flags, tokens, caches, active=None)
                                              -> (logits, caches[, sel])
  chunk_step(params, cfg, flags, tokens, caches, chunk_len, active=None,
             sel_len=None)                    -> (logits, caches)
  verify_step(params, cfg, flags, tokens, caches, active=None,
              scratch=None)                   -> (logits, caches)
  commit_chunk(cfg, flags, caches, keep, c, active=None, scratch=None)
                                              -> caches
  spec_scratch(caches, c)                     -> the pair's scratch
  init_cache(cfg, batch, max_len, flags, ..., pages=None) -> caches
  model_param_specs(cfg)                      -> logical axes of params
  unstacked_cache_specs(cfg, caches)          -> logical axes of caches
  attn_caches(caches)                         -> each layer's attention cache
  cross_caches(caches)                        -> each cross sub-layer's cache
  zero_cache(caches)                          -> caches (in place)
  truncate_cache(cfg, caches, length)         -> caches (in place)

Parameters are nested dicts of tensors, one dict per group in
``params["groups"]`` (the JAX reference stacks groups over a leading
layer axis; ``repro_torch.convert`` unstacks them).  Caches are likewise a
per-layer list, ``caches["groups"][i]["b0"]["attn"]``: the layout the
reference's ``unstack_group_caches`` produces for its decode loop, so no
unstacking step is needed here.  An RWKV6 layer's cache holds its
recurrent state ``s`` and the last tokens ``x_prev`` and ``ffn_prev``
instead of K/V rows, a Mamba layer's its state ``h`` and its conv
history ``conv`` (a hybrid group, jamba's, holds both kinds: "b0".."b7"),
an MLA layer's the latent rows ``c_kv`` and ``k_rope``.  A dense
prologue (deepseek_v3's ``first_k_dense`` layers: the arch's attention
and a dense MLP) runs before the groups, its
params and caches in the per-layer lists ``params["prologue"]`` and
``caches["prologue"]``, unstacked in the reference too.

Encoder-decoder and cross-attention archs take their second input in
``extras``, as the reference's batch dict does: ``{"enc_x": (B, T, d)}``,
whisper's precomputed frame embeddings, which the encoder
(``params["enc_groups"]``, ``n_enc_layers`` groups of one non-causal
attention sub-block, then ``enc_norm``) turns into the cross-attention's
input after adding sinusoidal positions; ``{"img": (B, T, d)}``,
llama_3_2_vision's patch embeddings, used as they are.  Whisper's decoder
adds sinusoidal positions to its token embeddings over the INPUT's
length, as the reference does, so a decode step's token gets position
0's (a reference fault, ROADMAP Queue 3); its attention uses no RoPE.  A
cross sub-layer's cache (``caches["groups"][i][name]["xattn"]``:
``ck``/``cv`` of ``enc_seq_len`` or ``n_image_tokens`` rows) is written
whole by a prefill with extras and read by every decode step; without
extras prefill skips the sub-layer and decode reads what the cache
holds (zeros after ``init_cache`` or ``zero_cache``).  The encoder runs
in train mode with the call's ``dsa_mode`` (its ``mse`` joins ``aux`` in
training), the prefill's block or token path by its frame count.

Tensor parallelism (``flags.tp``, the "model" group of a serving mesh;
inference/engine.py): the weights are this rank's shard and ``cfg``
its geometry.  The embedding lookup reads this rank's vocab rows and
all-reduces, each layer all-reduces its attention out-projection and
its MLP down-projection (or MoE combine), and the head all-gathers its
V / tp logit columns (only the ``last`` rows of a prefill or a chunk):
2 * n_layers + 1 all-reduces and one all-gather a decode step
(distributed/collectives.py; a cross sub-layer adds its out-projection's,
and whisper's encoder, which takes the same form, 2 a layer at prefill:
``sharding.tp_decode_all_reduces``; RWKV6's mixes and Mamba's
``x_proj`` and ``out_proj``, ``models/ssm.py``; MLA's out-projection,
its latent cache whole on every rank, ``attention.apply_mla``).
In training (``forward_train`` under a
``distributed.sharding.TrainPlan``: ``flags.tp``, ``flags.sp``,
``flags.fsdp``) the same sites carry gradients: under sequence
parallelism the residual stream between the layers is this rank's
sequence rows, the embedding lookup reduce-scatters, each layer
all-gathers its inputs and reduce-scatters its outputs, and the head
gathers the normed rows and keeps its V / tp logit columns (the loss is
vocab-parallel); each layer's data-sharded (FSDP) leaves are gathered
inside its remat region, so the recompute gathers them again and none
is saved for the backward pass.

``forward_train`` is the training forward (``RunFlags(mode="train")``, no
cache): it also returns ``aux``, each of ``AUX_KEYS`` an f32 scalar summed
over the layers, the prologue's included (``mse``, the DSA predictor's
Eq. 6 term; ``router``,
the MoE load-balance term times ``router_aux_weight``, 0 on a dense
arch).  An MoE layer trains on the capacity route; decode, chunk and
verify steps run in decode mode and route decode-dense.  With ``cfg.remat`` each layer group runs
under ``torch.utils.checkpoint`` when a gradient is being taken, so the
backward pass recomputes its activations instead of holding them:
``remat_policy`` "full" recomputes everything, "dots" (the reference's
``dots_with_no_batch_dims_saveable``) keeps the outputs of the products
with no batch dimension (``aten.mm``/``addmm``: every ``x @ W`` on
(B, S, d)) and recomputes the rest (attention's batched products, norms,
elementwise passes), and "none" keeps everything.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig, is_recurrent
from repro_torch.core.prediction import mm
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives as C
from repro_torch.models import blocks as B
from repro_torch.core.quantization import raw
from repro_torch.models.attention import (PEND_KEY, RunFlags, _rebuild_ktb,
                                          as_active, commit_verify)
from repro_torch.models.common import (dense_init, rms_norm,
                                      sinusoidal_embedding)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

AUX_KEYS = ("mse", "router")


def init_model(seed: int, cfg: ArchConfig, *, device=None,
               place: Optional[Callable] = None) -> Dict[str, Any]:
    """Random weights from ``seed`` (a ``torch.Generator`` on the target
    device), in ``cfg.param_dtype``, but for an MoE router, which is f32
    as in the reference.  ``device=None`` means the card.

    ``place(piece, specs)``, when given, takes each piece as soon as it
    is drawn (the embedding, each sub-block of a layer group, the final
    norm, the head, ...) with its subtree of ``model_param_specs``, and
    returns what the tree keeps of it: an engine on a serving mesh
    passes one that keeps this rank's shard (``Engine``), so the device
    holds the shards drawn so far and one piece whole, never the whole
    tree.  The draws, and so the weights, are those of ``place=None``."""
    dev = resolve_device(device)
    dt = DTYPES[cfg.param_dtype]
    # on "meta" (shapes alone: a training plan's) there is no generator
    gen = (None if dev.type == "meta" else
           torch.Generator(device=dev).manual_seed(seed))
    kw = dict(device=dev, dtype=dt)
    keep = place or (lambda piece, specs: piece)
    specs = model_param_specs(cfg)
    params: Dict[str, Any] = {
        "embed": keep(dense_init(gen, (cfg.vocab, cfg.d_model), **kw),
                      specs["embed"]),
        "groups": [B.init_group(gen, cfg, place=_sub_place(keep, s), **kw)
                   for s in specs["groups"]],
        "final_norm": keep(torch.ones((cfg.d_model,), **kw),
                           specs["final_norm"]),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = keep(dense_init(gen, (cfg.d_model, cfg.vocab),
                                            **kw), specs["lm_head"])
    if B.n_prologue(cfg):
        params["prologue"] = [keep(B.init_subblock(gen, cfg,
                                                   B.prologue_def(cfg), **kw),
                                   s)
                              for s in specs["prologue"]]
    if cfg.enc_dec:
        params["enc_groups"] = [B.init_group(gen, cfg, decoder=False,
                                             place=_sub_place(keep, s), **kw)
                                for s in specs["enc_groups"]]
        params["enc_norm"] = keep(torch.ones((cfg.d_model,), **kw),
                                  specs["enc_norm"])
    return params


def _sub_place(keep: Callable, specs: Dict[str, Any]) -> Callable:
    """``init_group``'s ``place`` for a group whose spec tree is ``specs``:
    ``keep`` each sub-block with its own subtree."""
    return lambda name, sub: keep(sub, specs[name])


def model_param_specs(cfg: ArchConfig) -> Dict[str, Any]:
    """Logical-axis spec tree parallel to ``init_model(seed, cfg)``, built
    from ``cfg`` alone, without allocating (the reference's, without its
    stacked layer axis: the port's ``groups`` is a per-group list).  The
    serving engines resolve it against a tensor-parallel mesh to place
    each rank's shard of the weights (inference/engine.py)."""
    def group(decoder=True):
        return {f"b{i}": B.subblock_param_specs(cfg, d)
                for i, d in enumerate(B.group_defs(cfg, decoder))}

    specs: Dict[str, Any] = {
        "embed": ("vocab", "embed"),
        "groups": [group() for _ in range(B.n_groups(cfg))],
        "final_norm": ("embed_act",)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = ("embed", "vocab")
    if B.n_prologue(cfg):
        specs["prologue"] = [B.subblock_param_specs(cfg, B.prologue_def(cfg))
                             for _ in range(B.n_prologue(cfg))]
    if cfg.enc_dec:
        specs["enc_groups"] = [group(False)
                               for _ in range(B.n_groups(cfg, False))]
        specs["enc_norm"] = ("embed_act",)
    return specs


def set_cross_gates(params, gate: float) -> Dict[str, Any]:
    """``params`` with every cross gate ``xgate`` filled with ``gate``, in
    place.  The gates start at 0, and tanh(0) = 0: until they move,
    neither whisper's encoder nor llama's image reaches the logits, so a
    check of the cross path sets them first."""
    with torch.no_grad():
        for group in params["groups"]:
            for sub in group.values():
                if "xgate" in sub:
                    sub["xgate"].fill_(gate)
    return params


def _call(fn, lp, prefix, *args):
    return fn(lp, *args)


def _encode(params, cfg: ArchConfig, flags: RunFlags, enc_x, run=_call):
    """Whisper's encoder over precomputed frame embeddings (B, T, d):
    sinusoidal positions, the encoder groups under train-mode flags with
    the call's ``dsa_mode`` (the MSE only when the call trains), then
    ``enc_norm``.  ``run(fn, gp, prefix, x)`` runs one group (its leaves
    at ``prefix``; under a checkpoint when training with remat).  Returns
    (enc (B, T, d), aux).

    Tensor parallelism (``flags.tp``): the encoder's layers take the
    decoder's form (each all-reduces its out-projection and its MLP's
    down-projection, 2 all-reduces a layer in a serving prefill).  In
    training under sequence parallelism the frames are laid out as the
    decoder's tokens, T / tp rows a rank between the layers (T must
    divide by tp), and the normed output is all-gathered over the
    sequence once: every cross sub-layer reads it whole (1 all-gather
    forward, its reduce-scatter backward, which adds the ranks' partial
    key/value gradients).  Without SP the output enters the decoder
    through ``collectives.copy_to_tp``: 1 all-reduce backward, of those
    partial gradients."""
    tp, train = flags.tp, flags.mode == "train"
    sp = train and flags.sp
    x = enc_x + sinusoidal_embedding(enc_x.shape[1], cfg.d_model,
                                     enc_x.dtype, device=enc_x.device)[None]
    if sp:
        t = x.shape[1]
        if t % tp.size:
            raise ValueError(f"{cfg.name}: {t} encoder frames do not divide "
                             f"by tp={tp.size} under sequence parallelism")
        x = x.narrow(1, tp.rank * (t // tp.size), t // tp.size)
    defs = B.group_defs(cfg, decoder=False)
    eflags = RunFlags(mode="train", dsa_mode=flags.dsa_mode,
                      with_mse=flags.with_mse and train, tp=tp, sp=sp)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = {k: zero for k in AUX_KEYS}

    def group(gp, x):
        x, _, a = B.apply_group(gp, cfg, eflags, defs, x)
        a = _norm_aux(a, zero)
        return (x,) + tuple(a[k] for k in AUX_KEYS)

    for i, gp in enumerate(params["enc_groups"]):
        x, *a = run(group, gp, f"/enc_groups/{i}", x)
        aux = {k: aux[k] + v for k, v in zip(AUX_KEYS, a)}
    enc = rms_norm(x, params["enc_norm"].to(x.dtype), cfg.norm_eps)
    if sp:
        enc = C.gather_seq(enc, tp)
    elif train and tp is not None:
        enc = C.copy_to_tp(enc, tp)
    return enc, aux


def _embed(params, cfg: ArchConfig, flags: RunFlags, tokens, extras,
           run=_call):
    """The token embeddings (whisper's with sinusoidal positions over
    their length) and the cross-attention input from ``extras`` (None
    without one): (x, enc, encoder aux or None).  Under tensor
    parallelism the encoder's output and the image embeddings are whole
    on every rank (``_encode``)."""
    dt = DTYPES[cfg.dtype]
    emb, tp = params["embed"], flags.tp
    if tp is not None and emb.shape[0] * tp.size == cfg.vocab:
        # this rank's vocab rows: the others' tokens read zeros, and one
        # all-reduce over "model" puts every row back (in training under
        # sequence parallelism a reduce-scatter: this rank's rows)
        vl = emb.shape[0]
        ids = tokens.long() - tp.rank * vl
        ok = (ids >= 0) & (ids < vl)
        x = torch.where(ok[..., None], emb[ids.clamp(0, vl - 1)], 0)
        x = C.tp_exit(x.to(dt), tp, train=flags.mode == "train", sp=flags.sp)
    else:
        x = emb[tokens.long()].to(dt)
    extras = extras or {}
    enc, aux = None, None
    if cfg.enc_dec and "enc_x" in extras:
        enc, aux = _encode(params, cfg, flags, extras["enc_x"].to(dt), run)
    elif cfg.cross_attn_period and "img" in extras:
        enc = extras["img"].to(dt)
    if cfg.enc_dec:
        pe = sinusoidal_embedding(tokens.shape[1], cfg.d_model, dt,
                                  device=x.device)
        if x.shape[1] != tokens.shape[1]:
            # sequence parallelism: this rank's rows, at their positions
            pe = pe.narrow(0, tp.rank * x.shape[1], x.shape[1])
        x = x + pe[None]
    return x, enc, aux


def forward(params, cfg: ArchConfig, flags: RunFlags, tokens: torch.Tensor,
            caches=None, extras=None, last=None, **step):
    """tokens: (B, S) int; ``extras``: {"enc_x" | "img": (B, T, d)}
    tensors (see the module docstring).  Returns (logits (B, S, V),
    caches), and with ``flags.sel_probe`` the selection list of
    ``decode_step`` third.  ``last`` (B,): return only each row's logits
    row at that position, (B, 1, V) (a prefill's or a chunk's last real
    token; under tensor parallelism only those rows are gathered).
    ``step``: the decode-time ``active``, ``chunk_len`` and ``sel_len``
    (see ``decode_step`` and ``chunk_step``)."""
    x, enc, _ = _embed(params, cfg, flags, tokens, extras)
    pro = B.prologue_def(cfg)
    for i, lp in enumerate(params.get("prologue", ())):
        c = None if caches is None else caches["prologue"][i]
        x, _, _ = B.apply_subblock(lp, cfg, flags, pro, x, cache=c, enc=enc,
                                   **step)
    defs = B.group_defs(cfg)
    sel: List[tuple] = []
    for i, gp in enumerate(params["groups"]):
        c = None if caches is None else caches["groups"][i]
        x, _, aux = B.apply_group(gp, cfg, flags, defs, x, cache=c, enc=enc,
                                  **step)
        sel += aux.get("sel", [])
    logits = _head(params, cfg, x, flags, last)
    return (logits, caches, sel) if flags.sel_probe else (logits, caches)


def _head(params, cfg: ArchConfig, x, flags: Optional[RunFlags] = None,
          last=None):
    """Logits (B, S, V), or (B, 1, V) at the rows ``last`` (B,).  Under
    tensor parallelism a vocab-sharded head gives this rank's V / tp
    columns, and one all-gather over "model" assembles the rows.  In
    training the columns stay apart (the loss is vocab-parallel,
    ``training.steps.cross_entropy``), and under sequence parallelism the
    normed rows are all-gathered over the sequence first."""
    x = rms_norm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)
    tp = None if flags is None else flags.tp
    train = flags is not None and flags.mode == "train"
    x = C.tp_enter(x, tp, train=train, sp=train and flags.sp)
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    logits = mm(x, head.to(x.dtype))
    if last is not None:
        rows = torch.arange(logits.shape[0], device=logits.device)
        logits = logits[rows, last.long()][:, None]
    if (tp is not None and not train
            and logits.shape[-1] * tp.size == cfg.vocab):
        logits = C.all_gather(logits, tp, dim=-1)
    return logits


def _norm_aux(aux: Dict, zero: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Every key of ``AUX_KEYS`` as an f32 scalar, 0 where ``aux`` has
    none."""
    return {k: aux[k].float() if k in aux else zero for k in AUX_KEYS}


# the products ``remat_policy="dots"`` keeps: a matmul with no batch
# dimension (jax's dot_general without batch dims) lowers to these
DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in DOTS_SAVED
            else CheckpointPolicy.PREFER_RECOMPUTE)


_DOTS_CONTEXT = functools.partial(create_selective_checkpoint_contexts,
                                  _dots_policy)


def forward_train(params, cfg: ArchConfig, flags: RunFlags,
                  tokens: torch.Tensor, extras=None):
    """tokens: (B, S) int; ``extras`` as for ``forward``.  Returns (logits
    (B, S, V), aux): the training forward, each aux term summed over the
    layers, an encoder's included (a sum, not a mean, as the reference's
    layer scan carries it)."""
    if flags.mode != "train":
        raise ValueError("forward_train needs RunFlags(mode='train')")
    if cfg.remat_policy not in ("full", "dots", "none"):
        raise ValueError(f"remat_policy {cfg.remat_policy!r}: 'full', "
                         f"'dots' or 'none'")
    remat = cfg.remat and cfg.remat_policy != "none"
    ckpt = dict(use_reentrant=False)
    if cfg.remat_policy == "dots":
        ckpt["context_fn"] = _DOTS_CONTEXT

    plan = flags.fsdp
    if plan is not None:
        # the non-layer leaves' data-sharded dims, gathered once a call
        top = {k: v for k, v in params.items()
               if k not in ("groups", "prologue", "enc_groups")}
        params = {**params, **C.fsdp_gather_tree(top, "", plan.gathers)}

    def run(fn, lp, prefix, *args):
        # a layer: its data-sharded leaves gathered inside the remat
        # region, so the recompute gathers again and none is saved
        body = fn if plan is None else (
            lambda lp, *a: fn(C.fsdp_gather_tree(lp, prefix, plan.gathers,
                                                 plan.kv_slices), *a))
        if remat and torch.is_grad_enabled():
            return checkpoint(body, lp, *args, **ckpt)
        return body(lp, *args)

    x, enc, enc_aux = _embed(params, cfg, flags, tokens, extras, run)
    defs = B.group_defs(cfg)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = {k: zero for k in AUX_KEYS}

    def group(gp, x, enc):
        x, _, a = B.apply_group(gp, cfg, flags, defs, x, enc=enc)
        a = _norm_aux(a, zero)
        return (x,) + tuple(a[k] for k in AUX_KEYS)

    def prologue(lp, x, enc):
        x, _, a = B.apply_subblock(lp, cfg, flags, B.prologue_def(cfg), x,
                                   enc=enc)
        a = _norm_aux(a, zero)
        return (x,) + tuple(a[k] for k in AUX_KEYS)

    layers = [(prologue, lp, f"/prologue/{i}")
              for i, lp in enumerate(params.get("prologue", ()))]
    layers += [(group, gp, f"/groups/{i}")
               for i, gp in enumerate(params["groups"])]
    for fn, lp, prefix in layers:
        x, *a = run(fn, lp, prefix, x, enc)
        aux = {k: aux[k] + v for k, v in zip(AUX_KEYS, a)}
    if enc_aux is not None:
        aux = {k: aux[k] + enc_aux[k] for k in AUX_KEYS}
    return _head(params, cfg, x, flags), aux


def decode_step(params, cfg: ArchConfig, flags: RunFlags, tokens, caches,
                active=None):
    """tokens: (B, 1).  Returns (logits (B, 1, V), caches).

    active: optional continuous-batching slot mask: a (B,) bool mask
    (fixed shapes, no host sync: the form a CUDA graph captures), or a
    ``models.attention.Active`` that may also hold the indices of its
    rows.  An inactive row lands no write, keeps its ``pos`` and attends
    nothing (its logits are garbage and must be ignored).

    With ``flags.sel_probe`` it returns (logits, caches, sel): ``sel``
    lists each DSA layer's block selection (idx, ok, kv_len) in layer
    order, on the block and kernel paths (logical block indices on a
    paged cache)."""
    if flags.mode != "decode":
        raise ValueError("decode_step needs RunFlags(mode='decode')")
    return forward(params, cfg, flags, tokens, caches,
                   active=as_active(active))


def chunk_step(params, cfg: ArchConfig, flags: RunFlags, tokens, caches,
               chunk_len, active=None, sel_len=None, last=None):
    """``decode_step`` generalised from 1 token to a C-token chunk
    (chunked admission).  tokens: (B, C), each row's next C prompt tokens
    appended at its ``pos``, right-padded; chunk_len: (B,) true token
    count per row.  Returns (logits (B, C, V), caches).

    Every layer writes its C rows at ``pos`` (pad rows as zeros, the
    truncate_cache state), advances ``pos`` by chunk_len, extends ktb by
    a scatter-add of per-block partial sums, and attends the chunk to the
    cache prefix and its own causal triangle.  ``sel_len`` (default the
    cache length) is the selection and attention geometry: chunks over a
    prompt-bucket cache leave the cache (and final-row logits) of a
    whole-prompt bucketed prefill.  Logits rows at or past chunk_len are
    garbage; inactive rows freeze; ``last`` (B,) returns only each row's
    row there, (B, 1, V), as ``forward``.  On the DSA block path C and ``pos``
    are multiples of block_q and block_k.  Dense caches of attention
    archs only: a recurrent (RWKV6, Mamba) state absorbs pad rows."""
    if flags.mode != "decode":
        raise ValueError("chunk_step needs RunFlags(mode='decode')")
    if is_recurrent(cfg):
        raise NotImplementedError(
            f"chunk_step: {cfg.name} is recurrent; its state cannot skip a "
            f"chunk's pad rows")
    return forward(params, cfg, flags, tokens, caches, last=last,
                   active=as_active(active), chunk_len=chunk_len,
                   sel_len=sel_len)


def cross_caches(caches) -> Iterator[Dict[str, Any]]:
    """Every cross-attention sub-layer's cache dict (``ck``/``cv``), in
    layer order."""
    for group in caches["groups"]:
        for sub in group.values():
            if "xattn" in sub:
                yield sub["xattn"]


def attn_caches(caches) -> Iterator[Dict[str, Any]]:
    """Every layer's attention cache dict (K/V, latent or recurrent
    leaves), in layer order: the dense prologue's first, then each
    group's sub-blocks."""
    for sub in caches.get("prologue", ()):
        yield sub["attn"]
    for group in caches["groups"]:
        for sub in group.values():
            yield sub["attn"]


def spec_scratch(caches, c: int) -> List[Optional[torch.Tensor]]:
    """The scratch a ``verify_step`` and its ``commit_chunk`` share beside
    ``caches``, one entry per layer (``attn_caches`` order): a (B, C, k)
    f32 buffer where the layer's cache holds an int8 ktb (the verify keeps
    its rows' float K~ there and the commit's ktb replay adds them, as the
    decode step adds the float row), else None (an MLA layer has no
    ktb).  The cache's own layout never changes; a graph captured over a
    scratch replays into it, so its owner keeps it."""
    def one(lc):
        if "ktb_s" not in lc or "page_tbl" in lc:
            return None
        kt = lc["kt"]
        return torch.zeros((kt.shape[0], c, kt.shape[-1]),
                           dtype=torch.float32, device=kt.device)
    return [one(lc) for lc in attn_caches(caches)]


def _with_scratch(caches, scratch):
    """A view of ``caches`` (the same tensors, written in place) with each
    layer's ``spec_scratch`` entry beside its leaves."""
    if scratch is None:
        return caches
    it = iter(scratch)

    def put(sub):
        return {**sub, "attn": {**sub["attn"], PEND_KEY: next(it)}}

    view = dict(caches)
    if "prologue" in caches:
        view["prologue"] = [put(sub) for sub in caches["prologue"]]
    view["groups"] = [{name: put(sub) for name, sub in group.items()}
                      for group in caches["groups"]]
    return view


def verify_step(params, cfg: ArchConfig, flags: RunFlags, tokens, caches,
                active=None, scratch=None):
    """Speculative draft-verify step: ``chunk_step`` routed through the
    per-row decode numerics of the verify attention (``flags.spec_verify``
    must be set).  tokens: (B, C), each row's pending token followed by
    C-1 drafts, appended at its ``pos``.  Returns (logits (B, C, V),
    caches): row i's logits are those of the ``decode_step`` chain after
    committing rows < i (the same tokens; the bytes differ where a product
    over C rows rounds otherwise than one over 1 row), so the caller can
    accept drafts and roll back the rest with ``commit_chunk``.  Every row
    writes K/V/kt (ktb waits for the commit) and ``pos`` advances by C on
    active rows: a verify step must be followed by ``commit_chunk``.
    ``active``: a (B,) bool mask; an inactive row writes nothing.
    ``scratch``: ``spec_scratch(caches, C)``, needed where a layer keeps
    an int8 ktb on the block paths, and passed to the commit too."""
    if flags.mode != "decode" or not flags.spec_verify:
        raise ValueError("verify_step needs RunFlags(mode='decode', "
                         "spec_verify=True)")
    if is_recurrent(cfg):
        raise NotImplementedError(
            f"verify_step: {cfg.name} is recurrent; its state cannot roll "
            f"back rejected drafts")
    b, c = tokens.shape
    chunk_len = torch.full((b,), c, dtype=torch.int32, device=tokens.device)
    logits, _ = forward(params, cfg, flags, tokens,
                        _with_scratch(caches, scratch),
                        active=as_active(active), chunk_len=chunk_len)
    return logits, caches


def commit_chunk(cfg: ArchConfig, flags: RunFlags, caches, keep, c: int,
                 active=None, scratch=None):
    """Commit the accepted prefix of a ``verify_step`` and roll back the
    rejected tail, in place, every layer: keep (B,) accepted rows per row
    (ignored on inactive rows); the verify wrote C rows at ``start = pos -
    C``.  Zeroes every per-token row (k, v, kt and their scales, or an
    MLA layer's c_kv and k_rope) in
    [start + keep, start + C), sets ``pos = start + keep`` and, on the
    block and kernel paths, replays the decode step's ktb update for the
    accepted rows (``models.attention.commit_verify``), so the cache is
    what sequential decode leaves after ``keep`` steps of the same rows.
    ``flags`` and ``scratch`` are the verify's.  Raises on a paged
    cache."""
    act = as_active(active)
    for lc in attn_caches(_with_scratch(caches, scratch)):
        commit_verify(cfg, flags, lc, keep, c, act)
    return caches


def init_cache(cfg: ArchConfig, batch: int, max_len: int, flags: RunFlags,
               *, dtype=torch.bfloat16, device=None, pages=None
               ) -> Dict[str, Any]:
    """pages: page count of a PAGED cache: every layer's k/v (and DSA
    kt/ktb) become flat page pools indirected by a per-slot ``page_tbl``
    over the logical [0, max_len) geometry (see
    models.attention.init_cache_attention).  A cross sub-layer's
    ``ck``/``cv`` hold ``enc_seq_len`` (whisper) or ``n_image_tokens``
    (llama_3_2_vision) rows."""
    dev = resolve_device(device)
    enc_len = (cfg.enc_seq_len if cfg.enc_dec else
               cfg.n_image_tokens if cfg.cross_attn_period else 0)
    kw = dict(device=dev, dtype=dtype, pages=pages, enc_len=enc_len)
    defs = B.group_defs(cfg)
    caches: Dict[str, Any] = {"groups": [
        {f"b{i}": B.init_subblock_cache(cfg, d, batch, max_len, flags, **kw)
         for i, d in enumerate(defs)}
        for _ in range(B.n_groups(cfg))]}
    if B.n_prologue(cfg):
        caches["prologue"] = [
            B.init_subblock_cache(cfg, B.prologue_def(cfg), batch, max_len,
                                  flags, **kw)
            for _ in range(B.n_prologue(cfg))]
    return caches


def unstacked_cache_specs(cfg: ArchConfig, caches) -> Dict[str, Any]:
    """Logical-axis spec tree parallel to ``caches`` (``init_cache``'s
    per-layer layout, which is the reference's unstacked one): what the
    serving engines resolve to shard the resident cache's slot axis over
    "data" and its KV heads over "model"."""
    defs = B.group_defs(cfg)
    specs: Dict[str, Any] = {"groups": [
        {f"b{i}": B.subblock_cache_specs(cfg, d, g[f"b{i}"])
         for i, d in enumerate(defs)} for g in caches["groups"]]}
    if "prologue" in caches:
        specs["prologue"] = [B.subblock_cache_specs(cfg, B.prologue_def(cfg),
                                                    c)
                             for c in caches["prologue"]]
    return specs


def zero_cache(caches) -> Dict[str, Any]:
    """Zero every leaf of a cache in place: the state ``init_cache`` makes
    (fp8 leaves through their bytes), the cross sub-layers' ``ck``/``cv``
    included."""
    for lc in (*attn_caches(caches), *cross_caches(caches)):
        for t in lc.values():
            raw(t).zero_()
    return caches


# per-token cache leaves (and their quantization scales), masked past the
# true length
_ROW_KEYS = ("k", "v", "kt", "k_s", "v_s", "kt_s", "c_kv", "k_rope")


def truncate_cache(cfg: ArchConfig, caches, length) -> Dict[str, Any]:
    """Sanitise a freshly prefilled cache to its true prompt length(s), in
    place, every layer, the prologue's included: zero every per-token
    row (K/V, kt, MLA's c_kv and k_rope, and the scales) at slots >=
    length (on a ring, slots and not positions, as the reference does),
    rebuild ktb (ktb_s) from the masked kt, and set every ``pos`` to
    ``length`` (a scalar or per-row (B,) lengths).  fp8 rows are zeroed
    through their bytes: no arithmetic runs on an fp8 tensor.  Recurrent
    (RWKV6, Mamba) leaves are left untouched, as in the reference: their
    archs take no padded prompts; so are a cross sub-layer's ``ck``/``cv``,
    which are not token rows."""
    for c in attn_caches(caches):
        rows = [c[name] for name in _ROW_KEYS if name in c]
        if not rows:
            continue
        b, s = rows[0].shape[:2]
        ln = torch.as_tensor(length, device=rows[0].device).to(
            torch.int32).expand(b)
        keep = torch.arange(s, device=ln.device)[None, :] < ln[:, None]
        for t in map(raw, rows):
            t.mul_(keep.reshape(b, s, *([1] * (t.dim() - 2))).to(t.dtype))
        c["pos"].copy_(ln)
        if "ktb" in c:
            _rebuild_ktb(cfg, c)
    return caches
