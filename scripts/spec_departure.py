#!/usr/bin/env python3
"""Where a speculative verify row first departs from the decode step, on
one NVIDIA card: a diagnosis for when speculative tokens differ from the
plain ones.

    python3 scripts/spec_departure.py [--seed 0] [--layers 32]
        [--batch 4] [--prompt-len 4096] [--rounds 63] [--dtype bfloat16]

Builds the kernels, makes yi_6b at full width (``--layers`` cuts depth)
with random weights from ``--seed`` and a kernel-path engine, prefills
the seed's random prompts twice and walks the rounds eagerly with every
model op recorded (``first_departure``).  Prints the first round, layer
and op where a verify row differs from the decode step, or that none
does.  ``chip_smoke.py``'s speculative static slice uses the same
weights, prompts and engine at the defaults.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def first_departure(eng, prompts, k: int, rounds: int) -> str:
    """Where a verify row first departs from the decode step.  From one
    prefilled state, eager, round by round along the rows' own greedy
    tokens: a decode step of the pending token against a verify of the
    pending token and K drafts that are all wrong, then a commit of that
    one row.  Records per layer the projections q, k, v, the predicted
    q~, k~, the block selection, the attention (K1's output), the output
    projection and the MLP, then the lm head (counted as the layer after
    the last), and compares the verify's row 0 with the step's, then
    every cache leaf after the commit.  Returns the first round, layer
    and op (or leaf) that differ, with the largest difference, or that
    none does in ``rounds`` rounds."""
    from repro_torch.core import masks as M
    from repro_torch.core import prediction as PRED
    from repro_torch.core.quantization import raw
    from repro_torch.kernels import ops
    from repro_torch.models import attention as TMA
    from repro_torch.models import blocks as TB
    from repro_torch.models import transformer as TT
    rec: list = []

    def hook(mod, name, ops_of):
        orig = getattr(mod, name)

        def fn(*a, **kw):
            out = orig(*a, **kw)
            rec.extend(ops_of(out))
            return out
        setattr(mod, name, fn)
        return mod, name, orig

    patches = [
        hook(TMA, "_proj_qkv", lambda o: [("q", o[0]), ("k", o[1]),
                                          ("v", o[2])]),
        hook(PRED, "predict_qk", lambda o: [("q~", o[0]), ("k~", o[1])]),
        hook(M, "decode_block_topk_indices", lambda o: [("selection",
                                                         o[0])]),
        hook(ops, "dsa_decode", lambda o: [("attention", o)]),
        hook(TMA, "_apply_decode", lambda o: [("output projection",
                                               o[0])]),
        hook(TMA, "_apply_verify", lambda o: [("output projection",
                                               o[0])]),
        hook(TB, "apply_mlp", lambda o: [("mlp", o)]),
        hook(TT, "_head", lambda o: [("lm head", o)])]
    b, c = prompts.shape[0], k + 1
    cfg = eng.cfg

    def layers():
        """{(layer, op): the first tensor}, a layer starting at each q."""
        d, li = {}, -1
        for op, t in rec:
            li += op in ("q", "lm head")
            d.setdefault((li, op), t.detach().float().clone())
        rec.clear()
        return d

    def leaves(caches):
        return [sub["attn"] for g in caches["groups"] for sub in g.values()]

    flags = dataclasses.replace(eng.decode_flags, spec_verify=True)
    one = torch.ones((b,), dtype=torch.long, device=eng.device)
    try:
        with torch.inference_mode():
            last, seq, _ = eng.prefill(prompts)
            _, ver, _ = eng.prefill(prompts)
            scratch = TT.spec_scratch(ver, c)
            tok = last[:, -1].argmax(dim=-1, keepdim=True)
            for t in range(rounds):
                rec.clear()
                lg = TT.decode_step(eng.params, cfg, eng.decode_flags, tok,
                                    seq)[0]
                st = layers()
                wrong = (tok + 1 + torch.arange(k, device=eng.device)
                         ) % cfg.vocab
                TT.verify_step(eng.params, cfg, flags,
                               torch.cat([tok, wrong], 1), ver,
                               scratch=scratch)
                v = layers()
                TT.commit_chunk(cfg, flags, ver, one, c, scratch=scratch)
                for key, a in st.items():        # in the order the ops ran
                    w = v[key]
                    w = (w.reshape(b, c, -1)[:, 0] if key[1] == "selection"
                         else w if key[1] == "attention" else w[:, :1])
                    diff = float((a - w.reshape(a.shape)).abs().max())
                    if diff:
                        return (f"round {t}, layer {key[0]}, {key[1]}: max "
                                f"|verify - decode step| {diff:.3g} (max "
                                f"|decode step| {float(a.abs().max()):.3g})")
                for li, (x, y) in enumerate(zip(leaves(seq), leaves(ver))):
                    for name in x:
                        if not torch.equal(raw(x[name]), raw(y[name])):
                            return (f"round {t}: after the commit, layer "
                                    f"{li}'s {name} differs from the decode "
                                    f"chain's")
                tok = lg[:, -1].argmax(dim=-1, keepdim=True)
    finally:
        for mod, name, orig in patches:
            setattr(mod, name, orig)
    return f"none in {rounds} rounds: every recorded op equal bit for bit"



def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0,
                    help="layers (0: the config's)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=4096)
    ap.add_argument("--rounds", type=int, default=63)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("spec_departure: needs a CUDA card")
    from repro_torch.configs.base import get_config
    from repro_torch.inference.engine import Engine
    from repro_torch.kernels import build
    from repro_torch.models.transformer import init_model
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    cfg = get_config("yi_6b")
    cfg = dataclasses.replace(cfg, n_layers=args.layers or cfg.n_layers,
                              dtype=args.dtype, param_dtype=args.dtype)
    eng = Engine(cfg, init_model(args.seed, cfg),
                 max_len=args.prompt_len + args.rounds + 17,
                 long_context=True, dsa_mode="kernel")
    prompts = np.random.default_rng(args.seed).integers(
        1, cfg.vocab - 4, size=(args.batch, args.prompt_len)).astype(np.int32)
    print(f"yi_6b, {cfg.n_layers} layers, {args.dtype}, batch {args.batch}, "
          f"prompt {args.prompt_len}, K {args.k}: first departure of a "
          f"verify row from the decode step: "
          f"{first_departure(eng, prompts, args.k, args.rounds)}", flush=True)


if __name__ == "__main__":
    main()
