"""Speculative decoding: draft-and-verify decode rounds (the reference's
``repro.inference.speculative``).

A decode step traverses the whole model (weights and cache) for one new
token per row.  Here a cheap DRAFT PROPOSER guesses K tokens per row and
ONE verify forward (``transformer.verify_step``) scores the pending token
and the K drafts, C = K + 1 rows, against the resident cache, each row
with the decode step's own numerics (``models.attention._apply_verify``:
its own selection and ``kv_len``, and on the kernel path one K1 call per
row, the decode step's call).  Row i's logits are those of the decode
step after the rows before it, so the engine draws the token the
sequential chain would draw there (argmax, or a Gumbel draw from the
row's own generator) and accepts the draft only if it equals that draw.
The ``m`` leading matches commit m + 1 tokens (the accepted drafts and
the corrected or bonus token), at most the row's remaining budget;
``transformer.commit_chunk`` rolls back the rest.  Wherever the verify
rows reproduce the decode step's logits, drafting moves only the
acceptance rate, never the tokens.

Contract: speculative tokens == plain tokens, greedy at any batch size
and sampled at B = 1, on TOKENS, not bytes.  The reference pins
verify-row logits bit for bit against the decode step's, which XLA on
a CPU gives; the port's products need not be row-invariant in their row
count (``x @ W`` over a (B, C, d) chunk may round otherwise than over
(B, 1, d) steps), so the logits agree to the last bits.  Measured: the
tokens are equal in f32 at reduced width on the CPU and at full width
(2 layers) on an H100; in bf16 at full width (yi_6b, 32 layers) they
are NOT: a last-bit difference in the predictor's product (its 4-bit
fake quant turns it into a whole level of q~/k~, hence another kt,
ktb and block selection) or in the MLP's (one bf16 step) changes a
greedy token after some rounds, and the rows then go their own way.
Computing the products row by row would force the bytes but read the
weights C times, the cost speculation exists to avoid (the predictor
alone row by row made a verify 1.7x slower and still left the MLP's
difference; ``PERF.md``, ``scripts/spec_departure.py``).

Sampling: each row keeps its own ``torch.Generator``, seeded as the B=1
chain of ``Engine.generate``.  Verify row i draws one (1, V) Gumbel row
from it (``engine._sample``) and the state after each draw is kept;
after acceptance the generator goes back to the state after exactly
``emit`` draws.  (One (C, V) draw would be another stream on the card:
Philox offsets advance per call.)  A sampled B > 1 batch therefore gets
each row's solo B=1 chain, not the plain path's batched draw, as the
continuous engine's slots do.  Greedy rows draw nothing.

On the card the verify forward and the commit are each one CUDA graph
replay (``inference/graphs.py``); acceptance runs eagerly between them,
and each round syncs once, to hand the tokens to the proposer.  With
telemetry on, the two are the programs ``verify`` and ``commit`` of
``Engine.spec_steps``: each new signature (on the CPU) or capture (on
the card) is a compile event.
Under a serving mesh a round runs on this rank's rows (data
parallelism) over this rank's heads (tensor parallelism: the verify's
logits are gathered over "model" before acceptance); the caller gathers
each round's tokens and emit counts over "data"
(``Engine.gather_rows``).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, is_recurrent
from repro_torch.inference.engine import _sample
from repro_torch.models.attention import DECODE_LOCAL, RunFlags
from repro_torch.models.transformer import forward_train


def can_speculate(cfg: ArchConfig, dsa_mode: str = "off", k: int = 1
                  ) -> bool:
    """Speculative verify is served wherever a chunk append with per-row
    decode numerics gives the decode step's tokens: non-wrapping caches
    (no recurrent Mamba or RWKV6 state to roll back, no SWA ring), and on
    the DSA paths a chunk of K + 1 rows inside the DECODE_LOCAL force-keep
    window, so the ktb entries the verify leaves stale are never read; no
    DSA over MLA (no predicted-key cache, as in ``can_chunk_prefill``).
    Encoder-decoder and cross-attention decoders are out, as in the
    reference.  MoE archs are served: decode steps and verify chunks both
    route the decode-dense expert path, and MLA verifies absorbed, as its
    decode step attends."""
    return (not is_recurrent(cfg) and cfg.swa_window == 0
            and not cfg.enc_dec and cfg.cross_attn_period == 0
            and not (cfg.mla is not None and dsa_mode != "off")
            and (dsa_mode == "off" or k + 1 <= DECODE_LOCAL))


# ---------------------------------------------------------------------------
# draft proposers
# ---------------------------------------------------------------------------


class DraftProposer:
    """Protocol of the draft proposers (host side; they move only the
    acceptance rate).

    ``propose(contexts, k)`` receives each row's whole token history
    (prompt and every emitted token, the last entry the pending token the
    next verify row scores again) and returns (B, k) int32 drafts."""

    def propose(self, contexts, k: int) -> np.ndarray:
        raise NotImplementedError


class NGramProposer(DraftProposer):
    """Self-drafting n-gram lookup (prompt-lookup decoding): find the
    longest trailing n-gram (n from ``max_n`` down to ``min_n``) earlier in
    the context and propose the k tokens that followed its most recent
    occurrence; with no match, repeat the last token.  A numpy scan of the
    history, no model."""

    def __init__(self, max_n: int = 3, min_n: int = 1):
        if not 1 <= min_n <= max_n:
            raise ValueError(f"need 1 <= min_n <= max_n, got {min_n}, "
                             f"{max_n}")
        self.max_n = max_n
        self.min_n = min_n

    def _one(self, ctx: np.ndarray, k: int) -> np.ndarray:
        fill = np.full((k,), ctx[-1] if ctx.size else 0, np.int32)
        n_hi = min(self.max_n, ctx.size - 1)
        for n in range(n_hi, self.min_n - 1, -1):
            pat = ctx[ctx.size - n:]
            n_start = ctx.size - n          # exclude the suffix itself
            if n_start <= 0:
                continue
            win = np.lib.stride_tricks.sliding_window_view(ctx, n)[:n_start]
            hits = np.flatnonzero((win == pat).all(axis=1))
            if hits.size:
                i = int(hits[-1])           # most recent occurrence
                cont = ctx[i + n:i + n + k]
                if cont.size:
                    out = fill.copy()
                    out[:cont.size] = cont
                    return out
        return fill

    def propose(self, contexts, k: int) -> np.ndarray:
        out = np.empty((len(contexts), k), np.int32)
        for r, ctx in enumerate(contexts):
            out[r] = self._one(np.asarray(ctx, np.int32), k)
        return out


class DraftModelProposer(DraftProposer):
    """A small draft model sharing the vocabulary: greedy continuation
    over each context's trailing ``window`` tokens through
    ``forward_train`` with DSA off (stateless: no draft cache to keep
    coherent with the slots).  The (B, window + k) buffer stays on the
    device across the k greedy steps, each step's argmax written in
    place: one upload and one download a round.  Draft positions restart
    at 0 inside the window, which shifts RoPE phases against the target
    model; that can only lower acceptance."""

    def __init__(self, cfg: ArchConfig, params, window: int = 64):
        self.cfg = cfg
        self.params = params
        self.window = int(window)
        self.flags = RunFlags(mode="train", dsa_mode="off", with_mse=False)

    @torch.inference_mode()
    def propose(self, contexts, k: int) -> np.ndarray:
        b, w = len(contexts), self.window
        buf = np.zeros((b, w + k), np.int32)
        lens = np.empty((b,), np.int64)
        for r, ctx in enumerate(contexts):
            ctx = np.asarray(ctx, np.int32)
            m = min(ctx.size, w)
            if m:
                buf[r, :m] = ctx[-m:]
            lens[r] = max(m, 1)
        start = lens.copy()
        dev = self.params["embed"].device
        dbuf = torch.as_tensor(buf, device=dev)            # one upload
        dlens = torch.as_tensor(lens, device=dev)
        rows = torch.arange(b, device=dev)
        for _ in range(k):
            logits, _ = forward_train(self.params, self.cfg, self.flags, dbuf)
            nxt = logits[rows, dlens - 1].argmax(dim=-1)
            dbuf[rows, dlens] = nxt.to(dbuf.dtype)
            dlens = dlens + 1
        out = dbuf.cpu().numpy()                           # one download
        return np.stack([out[r, start[r]:start[r] + k] for r in range(b)])


# ---------------------------------------------------------------------------
# the verify round
# ---------------------------------------------------------------------------


class SpeculativeDecoder:
    """One draft-verify-commit round for a fixed K, shared by
    ``Engine.generate(spec=K)`` and the continuous engine's speculative
    segments.  Stateless: the pending tokens, the caches (behind the
    ``verify`` and ``commit`` callables), the generators and the budgets
    are the caller's."""

    def __init__(self, k: int):
        if k < 1:
            raise ValueError("speculative decoding needs at least one draft "
                             "token")
        self.k = k

    def round(self, verify: Callable, commit: Callable, tok: torch.Tensor,
              drafts: np.ndarray, active: np.ndarray, remaining: np.ndarray,
              greedy: Sequence[bool], temps: Sequence[float],
              gens: List[Optional[torch.Generator]]
              ) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
        """One round over B rows.

        verify(chunk (B, C) int64, mask (B,) bool) -> logits (B, C, V):
        the verify forward over the rows' cache; commit(keep (B, 1)
        int64, mask (B,) bool): its ``commit_chunk``.  tok: (B, 1) the
        pending tokens, on the device; drafts: (B, K) host ints; active,
        remaining, greedy, temps and gens (a generator per sampled row)
        are per row, on the host.  Returns (tok' (B, 1) on the device,
        nxt (B, C) host: each row's drawn tokens, emit (B,) host: how many
        of them the row emits).  A sampled row's generator ends in the
        state after exactly ``emit`` draws."""
        dev = tok.device
        k = self.k
        d = torch.as_tensor(np.asarray(drafts, np.int64).reshape(-1, k),
                            device=dev)
        mask = torch.as_tensor(np.asarray(active, bool), device=dev)
        logits = verify(torch.cat([tok, d], dim=1), mask)  # (B, C, V)
        nxt = logits.argmax(dim=-1)                        # first maximum
        states = {}
        for r in range(len(gens)):
            if not active[r] or greedy[r]:
                continue
            st = []
            for i in range(k + 1):
                nxt[r, i] = _sample(logits[r:r + 1, i], gens[r], False,
                                    temps[r])[0, 0]
                st.append(gens[r].get_state())
            states[r] = st
        m = torch.cumprod((nxt[:, :k] == d).long(), dim=1).sum(dim=1)
        rem = torch.as_tensor(np.asarray(remaining, np.int64), device=dev)
        emit = torch.where(mask, torch.minimum(m + 1, rem), 0)
        commit(emit[:, None], mask)
        live = (emit > 0)[:, None]
        new_tok = torch.where(
            live, nxt.gather(1, (emit - 1).clamp(min=0)[:, None]), tok)
        host = torch.cat([nxt, emit[:, None]], dim=1).cpu().numpy()  # sync
        nxt_np, emit_np = host[:, :k + 1], host[:, k + 1]
        for r, st in states.items():
            if emit_np[r]:
                gens[r].set_state(st[emit_np[r] - 1])
        return new_tok, nxt_np.astype(np.int32), emit_np.astype(np.int64)
