"""Continuous-batching serving over the port's model (the reference's
``repro.inference.scheduler``, core path).

The static ``Engine.generate`` runs one fixed batch end to end.  The
``ContinuousEngine`` keeps one RESIDENT cache of ``slots`` rows alive and
streams requests through it:

  request queue   FIFO of submitted requests; admission requires
                  prompt_len + n_new <= max_len.
  segments        decode runs in segments of ``seg_len`` steps over ALL
                  slots, with the tokens kept on the device, synced to
                  the host once per segment.  The reference's segment is
                  one jitted scan (``_segment``); here each step is a
                  replay of the masked step's CUDA graph on the card
                  (inference/graphs.py, captured once per resident cache),
                  the same step run eagerly on the CPU.  Between segments
                  finished requests retire and queued ones are admitted
                  into free slots.  Per-slot ``pos`` and the (B,) active
                  mask (models/attention.py) let every slot decode at its
                  own depth and freeze.
  admission       DEFAULT (chunked): a same-bucket group's prompts stream
                  through a bucket-sized dense STAGING cache in fixed-width
                  chunk steps (transformer.chunk_step), in stall-bounded
                  bursts between decode segments.  A member whose prompt
                  ends samples its first token from that chunk's logits
                  row and is inserted into its reserved slot at once (the
                  whole slot row is overwritten, so no state leaks from an
                  earlier tenant).  BLOCKING (``chunked_prefill=False``,
                  and always where ``engine.can_chunk_prefill`` says no:
                  SWA archs): the group runs one ``Engine.prefill`` while
                  every resident decoder waits.  An SWA arch's resident
                  cache is a dense ring of min(max_len, window) rows per
                  slot; the insert zero-extends a prefill ring of
                  min(prompt, window) rows into it.
  paged cache     ``paged=True`` replaces the dense (slots, max_len) rows
                  by a page table over one shared pool (``PagePool`` keeps
                  the host's account; page 0 is the permanent zero page).
                  Pages are zeroed before they are mapped, so a slot's
                  logical view equals the dense zero-extended row.

Token-exactness: a request served here gets the tokens of
``Engine(cfg, params, max_len=<same>).generate(prompt[None], n_new,
greedy=..., seed=..., temperature=...)``: chunked admission over a
bucket-sized staging cache reproduces the bucketed whole-prompt prefill
(same selection geometry), and each slot samples from its own
``torch.Generator`` seeded by ``Request.seed``, drawn once per token as
the B=1 chain of ``Engine.generate`` is.  Paged serving gives the dense
tokens.  Pinned by tests/test_torch_scheduler.py.

Not ported yet (each raises ``NotImplementedError`` where a caller asks
for it): declared prefixes (``Request.prefix_len``, the prefix registry
and copy-on-write pages), a per-request ``dsa_mode`` other than the
engine's, speculative segments, deadlines, cancellation, shedding and
fault injection, telemetry and serving meshes; recurrent (RWKV6) archs.
Every ``dsa_mode`` of the engine is served, ``faithful`` included.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.quantization import raw
from repro_torch.inference.config import ServingConfig, resolve_config
from repro_torch.inference.engine import (Engine, _sample, _sync,
                                          can_chunk_prefill, can_page,
                                          pow2_bucket)
from repro_torch.inference.graphs import step_key
from repro_torch.models.attention import (DSA_MODES, _pool_write,
                                          cache_page_size)
from repro_torch.models.transformer import chunk_step, decode_step, init_cache

# cache leaves with a per-token (or per-block) row axis after the batch
# axis, quantization scales included: zero-extended from the staging
# bucket to the resident length at insertion
_SEQ_KEYS = ("k", "v", "kt", "ktb", "k_s", "v_s", "kt_s", "ktb_s")
# pool leaves holding one row per cached token, and one per page
_POOL_ROW_KEYS = ("k", "v", "kt", "k_s", "v_s", "kt_s")
_POOL_PAGE_KEYS = ("ktb", "ktb_s")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (L,) int32
    n_new: int
    greedy: bool = True
    seed: int = 0
    arrival_s: float = 0.0        # offset from serve() start (open loop)
    temperature: float = 1.0      # sampled (non-greedy) logit scale
    dsa_mode: Optional[str] = None  # only the engine's mode is ported
    prefix_len: int = 0           # declared shared prefix (not ported)
    deadline_s: Optional[float] = None   # latency budget (not ported)

    def __post_init__(self):
        if self.dsa_mode is not None and self.dsa_mode not in DSA_MODES:
            raise ValueError(
                f"Request.dsa_mode={self.dsa_mode!r} is not a valid DSA "
                f"mode; valid: {DSA_MODES} (or None for the engine default)")


# the reference's typed retirement statuses; the port's core path retires
# every request "ok" (the lifecycle that gives the others is not ported)
STATUSES = ("ok", "timeout", "cancelled", "failed", "shed")


@dataclasses.dataclass
class RequestResult:
    rid: int
    tokens: np.ndarray            # (n_new,)
    prompt_len: int
    n_new: int
    arrival_s: float
    admit_s: float
    finish_s: float
    first_token_s: float = 0.0    # when token 0 was sampled (TTFT anchor)
    status: str = "ok"            # one of STATUSES
    deadline_s: Optional[float] = None   # effective budget (SLO accounting)

    @property
    def latency_s(self) -> float:
        return self.finish_s - self.arrival_s

    @property
    def ttft_s(self) -> float:
        return self.first_token_s - self.arrival_s


@dataclasses.dataclass
class _SlotState:
    req: Request
    tok0: int
    collected: List[np.ndarray]
    remaining: int
    admit_s: float
    first_token_s: float = 0.0


@dataclasses.dataclass
class _PrefillGroup:
    """An in-flight chunked admission: one same-bucket group streaming
    through a bucket-sized staging cache."""
    reqs: List[Request]
    slots: List[Optional[int]]    # reserved resident slot per member
    bucket: int
    chunk: int                    # chunk width (min(chunk_tokens, bucket))
    caches: object                # staging cache (dense, bpf rows)
    lengths: np.ndarray           # (bpf,) true prompt length per row
    j: int = 0                    # next chunk index
    n_chunks: int = 0
    mat: Optional[np.ndarray] = None   # (bpf, n_chunks*chunk) padded tokens
    tbls: Optional[List] = None   # paged: per-member page-table row


def _layers(caches) -> Iterator[Dict]:
    """The attention cache dict of every layer."""
    for group in caches["groups"]:
        for sub in group.values():
            yield sub["attn"]


class PagePool:
    """Host-side account of a PAGED resident cache's physical pages.

    The device holds a flat pool of ``n_pages`` pages of ``page_rows``
    rows, indirected per slot through ``page_tbl``; this mirror decides
    which pages back which slot.  Page 0 is the permanent zero page,
    never allocated.  Invariant: every page in [1, n_pages) is either on
    the free stack or held (refcount 1), never both; sharing a page
    between slots comes with declared prefixes, which are not ported.
    Pages freed with data in them land in ``dirty`` and are zeroed on the
    device before their next mapping (``take_dirty``)."""

    def __init__(self, n_pages: int, page_rows: int):
        if n_pages < 2:
            raise ValueError(f"a pool needs the zero page and one more; "
                             f"got {n_pages} pages")
        self.n_pages = n_pages
        self.page_rows = page_rows
        self.free: List[int] = list(range(n_pages - 1, 0, -1))
        self.ref = np.zeros((n_pages,), np.int32)
        self.slot_pages: Dict[int, List[int]] = {}
        self.dirty: Set[int] = set()

    def available(self) -> int:
        return len(self.free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self.free):
            raise RuntimeError(
                f"page pool exhausted: need {n}, have {len(self.free)} "
                f"(admission accounting should have prevented this)")
        pages = [self.free.pop() for _ in range(n)]
        for p in pages:
            self.ref[p] = 1
        return pages

    def release(self, pages: Sequence[int]) -> None:
        for p in pages:
            self.ref[p] -= 1
            if self.ref[p] < 0:
                raise RuntimeError(f"page {p} over-released")
            if self.ref[p] == 0:
                self.free.append(p)
                self.dirty.add(p)

    def assign_slot(self, slot: int, pages: Sequence[int]) -> None:
        self.slot_pages[slot] = list(pages)

    def free_slot(self, slot: int) -> None:
        self.release(self.slot_pages.pop(slot))

    def take_dirty(self, pages: Sequence[int]) -> List[int]:
        """The subset of ``pages`` needing a device zero before use;
        marks them clean."""
        d = [p for p in pages if p in self.dirty]
        self.dirty.difference_update(d)
        return d


class ContinuousEngine:
    """Resident continuous-batching engine (see module docstring)."""

    def __init__(self, cfg: ArchConfig, params, *,
                 config: Optional[ServingConfig] = None, device=None, **kw):
        """``config`` (or keyword arguments, which are ServingConfig
        fields) as for ``Engine``; ``device=None`` means the card."""
        c = resolve_config(config, kw)
        if cfg.rwkv is not None:
            raise NotImplementedError(
                f"ContinuousEngine: {cfg.name} is recurrent; its slot "
                f"insert (a state overwrite under blocking admission) is "
                f"not ported yet: serve it with Engine.generate")
        self.config = c
        self.cfg = cfg
        self.slots = slots = c.slots
        self.max_len = max_len = c.max_len
        self.seg_len = c.seg_len
        # prefill machinery and flags are the static engine's, so the
        # scheduler is token-exact against Engine.generate per request
        self.engine = Engine(cfg, params, config=c, device=device,
                             loop="scan")
        self.device = self.engine.device
        # chunked admission replays the bucketed whole-prompt prefill;
        # SWA archs admit blocking (their prompts are not bucketed)
        chunk_ok = self.engine.bucket_prompts and can_chunk_prefill(cfg)
        self.chunked = chunk_ok if c.chunked_prefill is None else (
            c.chunked_prefill and chunk_ok)
        self.paged = c.paged
        if self.paged:
            if not can_page(cfg):
                raise ValueError(f"paged=True: {cfg.name} is outside the "
                                 f"paging envelope (no SWA ring caches)")
            # init_cache (in reset) refuses a max_len the pages do not tile
            self._page_rows = cache_page_size(cfg, self.engine.decode_flags)
            self._n_kb = -(-max_len // self._page_rows)
            # default pool: every slot can hold a full max_len sequence,
            # plus the permanent zero page
            self.pool_pages = (c.pool_pages if c.pool_pages is not None
                               else slots * self._n_kb + 1)
        else:
            self.pool_pages = 0
        # chunk width: pow2 and block-aligned, so chunk widths and starts
        # stay block_q/block_k multiples on the DSA paths (a chunk wider
        # than a small bucket is fine: its overhang rows are dropped)
        self._chunk_floor = 16
        if cfg.dsa.enabled:
            self._chunk_floor = max(self._chunk_floor, cfg.dsa.block_q,
                                    cfg.dsa.block_k)
        self.chunk_tokens = pow2_bucket(c.chunk_tokens, self._chunk_floor)
        self.queue: deque = deque()
        self.graphs = self.engine.graphs  # one pool for the engine's graphs
        self.reset()

    # -- queue / admission --------------------------------------------------

    def _pages_needed(self, req: Request) -> int:
        return -(-(len(req.prompt) + req.n_new) // self._page_rows)

    @torch.inference_mode()
    def _zero_pages(self, ids: Sequence[int]) -> None:
        """Zero pool pages ``ids`` in every pool leaf of every layer, so a
        freshly mapped page reads as zeros."""
        bk = self._page_rows
        ids = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        rows = (ids[:, None] * bk + torch.arange(
            bk, device=self.device)[None, :]).reshape(-1)
        for lc in _layers(self._caches):
            for keys, at in ((_POOL_ROW_KEYS, rows), (_POOL_PAGE_KEYS, ids)):
                for name in keys:
                    if name in lc:
                        raw(lc[name])[at] = 0

    def _zero_dirty(self, pages: Sequence[int]) -> None:
        """Zero the dirty subset of freshly mapped ``pages`` on the
        device."""
        d = self.pool.take_dirty(pages)
        if d:
            self._zero_pages(d)

    def submit(self, req: Request) -> None:
        plen = int(np.asarray(req.prompt).shape[-1])
        if plen == 0:
            raise ValueError(f"request {req.rid}: empty prompt — decode "
                             f"needs at least one context token")
        if req.rid in self._live:
            raise ValueError(f"request {req.rid}: rid already in flight — "
                             f"rids must be unique until their result is "
                             f"emitted")
        if plen + req.n_new > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt {plen} + n_new {req.n_new} "
                f"exceeds max_len {self.max_len}")
        if req.n_new < 1:
            raise ValueError(f"request {req.rid}: n_new must be >= 1")
        if req.temperature <= 0.0:
            raise ValueError(f"request {req.rid}: temperature must be > 0")
        if req.prefix_len:
            raise NotImplementedError(
                "declared prefixes (prefix_len, copy-on-write pages) are not "
                "ported to repro_torch yet")
        if req.deadline_s is not None:
            raise NotImplementedError(
                "request deadlines are not ported to repro_torch yet")
        if (req.dsa_mode is not None
                and req.dsa_mode != self.engine.decode_flags.dsa_mode):
            raise NotImplementedError(
                f"request {req.rid}: a per-request dsa_mode "
                f"({req.dsa_mode!r}) other than the engine's "
                f"({self.engine.decode_flags.dsa_mode!r}) is not ported yet")
        if self.paged and self._pages_needed(req) > self.pool_pages - 1:
            raise ValueError(
                f"request {req.rid}: needs {self._pages_needed(req)} cache "
                f"pages but the pool holds {self.pool_pages - 1} "
                f"allocatable pages — raise pool_pages or shorten it")
        self._live.add(req.rid)
        self.queue.append(req)

    def cancel(self, rid: int, now: float = 0.0) -> bool:
        raise NotImplementedError(
            "cancel (the request lifecycle) is not ported to repro_torch yet")

    def free_slots(self) -> List[int]:
        return [i for i in range(self.slots)
                if self._slot[i] is None and i not in self._reserved]

    def has_work(self) -> bool:
        return (bool(self.queue) or self._pf is not None
                or any(s is not None for s in self._slot))

    def _next_admissible(self) -> Optional[int]:
        """Queue index of the next request to admit.  Every request runs
        the engine's dsa_mode (the reference's mode-affine admission comes
        with per-request modes), so the queue is FIFO."""
        return 0 if self.queue else None

    def _group_for_admission(self, k: int, anchor: int) -> List[Request]:
        """Pop up to ``k`` queued requests sharing the anchor's prompt
        bucket, for one shared prefill batch (a row's prefill must be the
        one a solo ``Engine.generate`` at that bucket runs).  Skipped
        requests keep their order.  A paged engine also caps the group at
        what the pool can fund now; an unfundable anchor waits, with the
        whole queue, for retirements to return pages (nothing is then in
        flight only if every page is free, which funds any request that
        ``submit`` accepted)."""
        rest: deque = deque()
        for _ in range(anchor):
            rest.append(self.queue.popleft())
        first = self.queue.popleft()
        b0 = self.engine.prompt_bucket(len(first.prompt))
        budget = None
        if self.paged:
            def cost(r):
                return 0 if r.n_new <= 1 else self._pages_needed(r)

            need0 = cost(first)
            if need0 > self.pool.available():
                rest.append(first)
                while rest:
                    self.queue.appendleft(rest.pop())
                return []
            budget = self.pool.available() - need0
        group = [first]
        while self.queue and len(group) < k:
            r = self.queue.popleft()
            if self.engine.prompt_bucket(len(r.prompt)) == b0:
                if budget is not None:
                    if cost(r) > budget:
                        rest.append(r)
                        continue
                    budget -= cost(r)
                group.append(r)
            else:
                rest.append(r)
        while rest:
            self.queue.appendleft(rest.pop())
        return group

    def _sample_tok0(self, last_row: torch.Tensor, req: Request
                     ) -> Tuple[int, torch.Generator]:
        """A request's first token from its prefill logits row (1, V), with
        a generator of its own seeded as ``Engine.generate`` seeds."""
        gen = torch.Generator(device=self.device).manual_seed(req.seed)
        tok0 = _sample(last_row, gen, req.greedy, req.temperature)
        return int(tok0[0, 0]), gen

    def _activate(self, slot: int, req: Request, tok0: int,
                  gen: torch.Generator, admit_s: float,
                  first_s: float) -> None:
        self._tok[slot, 0] = tok0
        self._gens[slot] = gen
        self._active[slot] = True
        self._greedy[slot] = req.greedy
        self._temps[slot] = req.temperature
        self._slot[slot] = _SlotState(req, tok0, [], req.n_new - 1, admit_s,
                                      first_token_s=first_s)

    @torch.inference_mode()
    def _insert(self, pre, slot: int, row: int) -> None:
        """Overwrite resident slot ``slot`` with row ``row`` of a
        bucket-sized staging cache, zero-extending the per-token rows (a
        ring of min(prompt, window) rows into one of min(max_len,
        window): both place token i at slot i % window)."""
        for res, st in zip(_layers(self._caches), _layers(pre)):
            for name in _SEQ_KEYS:
                if name in res:
                    src = raw(st[name])[row]
                    dst = raw(res[name])[slot]
                    dst.zero_()
                    dst[:src.shape[0]] = src
            res["pos"][slot] = st["pos"][row]

    @torch.inference_mode()
    def _insert_paged(self, pre, slot: int, row: int,
                      tbl_row: np.ndarray) -> None:
        """Paged slot insert: write row ``row`` of a dense staging cache
        into the pages ``tbl_row`` maps and install the page-table row.
        Staged rows whose block is unmapped (beyond the slot's pages, all
        zero) are dropped; mapped pages were zeroed at allocation, so the
        slot's logical view equals the dense zero-extended insert."""
        bk = self._page_rows
        tbl = torch.as_tensor(tbl_row, dtype=torch.long, device=self.device)
        for res, st in zip(_layers(self._caches), _layers(pre)):
            r = torch.arange(st["k"].shape[1], device=self.device)
            pg = tbl[r // bk]
            flat = pg * bk + r % bk
            for name in _POOL_ROW_KEYS:
                if name in res:
                    _pool_write(res[name], flat, st[name][row], pg > 0)
            for name in _POOL_PAGE_KEYS:
                if name in res:
                    pgs = tbl[:st[name].shape[1]]
                    _pool_write(res[name], pgs, st[name][row], pgs > 0)
            res["page_tbl"][slot] = tbl.to(torch.int32)
            res["pos"][slot] = st["pos"][row]

    def _admit_group(self, slots: List[int], group: List[Request], clock,
                     results: List[RequestResult]) -> None:
        """BLOCKING admission: prefill a same-bucket group in one padded
        whole-prompt batch (``Engine.prefill``) and insert each row into a
        free slot.  Two batch widths per bucket (1 row for a single
        request, ``slots`` rows otherwise; surplus rows repeat a real
        prompt and are discarded), as the reference's fixed compile set
        has.  Every resident decoder waits for the whole prompt."""
        bpf = 1 if len(group) == 1 else self.slots
        bucket = self.engine.prompt_bucket(len(group[0].prompt))
        mat = np.full((bpf, bucket), self.engine.pad_id, np.int32)
        lengths = np.empty((bpf,), np.int32)
        for j in range(bpf):
            r = group[min(j, len(group) - 1)]
            p = np.asarray(r.prompt, np.int32)
            mat[j, :len(p)] = p
            lengths[j] = len(p)
        last, pcaches, tp = self.engine.prefill(mat, lengths=lengths,
                                                cache_len=bucket)
        self.stats["prefill_s"] += tp
        if any(s is not None for s in self._slot):
            self.stats["stall_s"] += tp       # resident decoders sat idle
        self.stats["admitted"] += len(group)
        now = clock()
        free = iter(slots)
        for j, req in enumerate(group):
            tok0, gen = self._sample_tok0(last[j:j + 1, -1], req)
            self.stats["useful_tokens"] += 1
            if req.n_new == 1:       # first token IS the whole generation
                self._emit(results, req, np.asarray([tok0], np.int32),
                           now, now, first_s=now)
                continue
            slot = next(free)
            if self.paged:
                npt = self._pages_needed(req)
                pages = self.pool.alloc(npt)
                self._zero_dirty(pages)
                self.pool.assign_slot(slot, pages)
                row = np.zeros((self._n_kb,), np.int32)
                row[:npt] = pages
                self._insert_paged(pcaches, slot, j, row)
            else:
                self._insert(pcaches, slot, j)
            self._activate(slot, req, tok0, gen, now, now)

    # -- chunked admission (default) ----------------------------------------

    def _start_chunked_group(self, free: List[int],
                             group: List[Request]) -> None:
        """Begin streaming a same-bucket group through a fresh bucket-sized
        staging cache; resident slots (and, paged, their pages) are
        reserved now and filled as each member's prompt completes."""
        bucket = self.engine.prompt_bucket(len(group[0].prompt))
        c = min(self.chunk_tokens, pow2_bucket(bucket, self._chunk_floor))
        bpf = 1 if len(group) == 1 else self.slots
        n_chunks = max(1, -(-max(len(r.prompt) for r in group) // c))
        mat = np.full((bpf, n_chunks * c), self.engine.pad_id, np.int32)
        lengths = np.empty((bpf,), np.int32)
        for j in range(bpf):
            r = group[min(j, len(group) - 1)]
            p = np.asarray(r.prompt, np.int32)
            mat[j, :len(p)] = p
            lengths[j] = len(p)
        caches = init_cache(self.cfg, bpf, bucket, self.engine.decode_flags,
                            dtype=self.engine.cache_dtype, device=self.device)
        slots: List[Optional[int]] = []
        it = iter(free)
        for r in group:
            slot = next(it) if r.n_new > 1 else None
            if slot is not None:
                self._reserved.add(slot)
            slots.append(slot)
        tbls = None
        if self.paged:
            tbls = []
            for r, slot in zip(group, slots):
                if slot is None:
                    tbls.append(None)     # staging-only member: no pages
                    continue
                npt = self._pages_needed(r)
                pages = self.pool.alloc(npt)
                self._zero_dirty(pages)
                self.pool.assign_slot(slot, pages)
                row = np.zeros((self._n_kb,), np.int32)
                row[:npt] = pages
                tbls.append(row)
        self._pf = _PrefillGroup(group, slots, bucket, c, caches,
                                 lengths, n_chunks=n_chunks, mat=mat,
                                 tbls=tbls)
        self.stats["admitted"] += len(group)

    def _chunk_burst(self) -> int:
        """How many chunks to run before yielding to a decode segment: the
        whole group with no resident decoder, else about one segment's
        worth of chunk time, tuned from the running timings."""
        pf = self._pf
        remaining = pf.n_chunks - pf.j
        if not any(s is not None for s in self._slot):
            return remaining
        st = self.stats
        if st["chunks"] and st["segments"] and st["chunk_s"] > 0:
            per_chunk = st["chunk_s"] / st["chunks"]
            per_seg = st["segment_s"] / st["segments"]
            return int(np.clip(round(per_seg / max(per_chunk, 1e-9)),
                               1, remaining))
        return 1                  # cold start: no timings yet

    @torch.inference_mode()
    def _chunk(self, pf: _PrefillGroup) -> torch.Tensor:
        """Chunk ``pf.j`` of an admission group over its staging cache
        (every row takes part); returns each row's logits (B, V) at its
        last real chunk token."""
        j, c = pf.j, pf.chunk
        cl = torch.as_tensor(np.clip(pf.lengths - j * c, 0, c).astype(
            np.int32), device=self.device)
        toks = torch.as_tensor(pf.mat[:, j * c:(j + 1) * c],
                               device=self.device)
        logits, _ = chunk_step(self.engine.params, self.cfg,
                               self.engine.decode_flags, toks, pf.caches, cl,
                               sel_len=pf.bucket)
        idx = cl.long().clamp(min=1) - 1
        return logits[torch.arange(logits.shape[0], device=self.device), idx]

    @torch.inference_mode()
    def step_prefill(self, clock, results: List[RequestResult],
                     max_chunks: Optional[int] = None) -> None:
        """Run a stall-bounded burst of chunks (at most ``max_chunks``) of
        the in-flight admission group (no-op without one).  A member whose
        prompt completes is inserted and activated at once; the host syncs
        only on a member's final chunk (to sample its first token) and at
        the end of the burst."""
        pf = self._pf
        if pf is None:
            return
        stalled = any(st is not None for st in self._slot)
        t0 = time.monotonic()
        synced = False
        burst = self._chunk_burst()
        if max_chunks is not None:
            burst = min(burst, max_chunks)
        for _ in range(burst):
            j = pf.j
            last = self._chunk(pf)
            pf.j += 1
            finishing = [i for i, r in enumerate(pf.reqs)
                         if -(-len(r.prompt) // pf.chunk) == j + 1]
            if not finishing:
                continue
            _sync(self.device)            # this chunk has completed
            synced = True
            now = clock()
            for i in finishing:
                req = pf.reqs[i]
                tok0, gen = self._sample_tok0(last[i:i + 1], req)
                self.stats["useful_tokens"] += 1
                if req.n_new == 1:        # retires without touching a slot
                    self._emit(results, req, np.asarray([tok0], np.int32),
                               now, now, first_s=now)
                    continue
                slot = pf.slots[i]        # early activation: decode now
                if self.paged:
                    self._insert_paged(pf.caches, slot, i, pf.tbls[i])
                else:
                    self._insert(pf.caches, slot, i)
                self._reserved.discard(slot)
                self._activate(slot, req, tok0, gen, now, now)
        if not synced:
            _sync(self.device)
        dt = time.monotonic() - t0
        self.stats["chunks"] += burst
        self.stats["chunk_s"] += dt
        if stalled:
            self.stats["stall_s"] += dt
        if pf.j >= pf.n_chunks:
            self._pf = None               # every member inserted already

    @torch.inference_mode()
    def admit_ready(self, clock, results: List[RequestResult]) -> None:
        """Admit queued requests into free slots.  ``clock``: zero-arg
        callable giving seconds since serve start.  Chunked mode only
        STARTS a group here (one in flight at a time); its chunks run in
        ``step_prefill`` between decode segments."""
        while self.queue:
            if self._pf is not None:
                break                     # a chunked group is in flight
            free = self.free_slots()
            if not free:
                break
            anchor = self._next_admissible()
            if anchor is None:
                break
            group = self._group_for_admission(len(free), anchor)
            if not group:
                break                     # the pool cannot fund the anchor
            if self.chunked:
                self._start_chunked_group(free, group)
                break
            self._admit_group(free, group, clock, results)

    def _emit(self, results: List[RequestResult], req: Request, tokens,
              admit_s: float, finish_s: float, first_s: float = 0.0) -> None:
        """Retire ``req``: its rid becomes reusable and its result is
        appended to ``results``."""
        self._live.discard(req.rid)
        results.append(RequestResult(
            req.rid, np.asarray(tokens, np.int32).reshape(-1),
            int(np.asarray(req.prompt).shape[-1]), req.n_new,
            req.arrival_s, admit_s, finish_s, first_token_s=first_s))

    def _partial(self, st: _SlotState) -> np.ndarray:
        """A slot's tokens so far: tok0 + every collected segment."""
        return np.concatenate(
            [np.asarray([st.tok0], np.int32)] + st.collected)

    def _retire_slot(self, i: int) -> None:
        """Free slot ``i``: clearing the host ``active`` mirror freezes it
        from the next segment on, and a paged slot returns its pages."""
        self._slot[i] = None
        self._gens[i] = None
        self._active[i] = False
        if self.paged:
            self.pool.free_slot(i)

    # -- warmup / reset ------------------------------------------------------

    @torch.inference_mode()
    def reset(self) -> None:
        """Zero all slots, the queue and the stats; rebuild the resident
        cache (and the page pool), dropping the decode graphs captured on
        the old one: the next segment captures anew."""
        if self.graphs is not None:
            self.graphs.clear()
        self.stats = {"segments": 0, "decode_steps": 0, "useful_tokens": 0,
                      "admitted": 0, "prefill_s": 0.0, "chunks": 0,
                      "chunk_s": 0.0, "stall_s": 0.0, "segment_s": 0.0}
        self._live: Set[int] = set()
        self.pool = (PagePool(self.pool_pages, self._page_rows)
                     if self.paged else None)
        self._caches = None               # free the old cache first
        self._caches = init_cache(
            self.cfg, self.slots, self.max_len, self.engine.decode_flags,
            dtype=self.engine.cache_dtype, device=self.device,
            pages=self.pool_pages if self.paged else None)
        self._tok = torch.zeros((self.slots, 1), dtype=torch.long,
                                device=self.device)
        self._gens: List[Optional[torch.Generator]] = [None] * self.slots
        self._active = np.zeros((self.slots,), bool)
        self._greedy = np.ones((self.slots,), bool)
        self._temps = [1.0] * self.slots
        self._slot: List[Optional[_SlotState]] = [None] * self.slots
        self._reserved: Set[int] = set()
        self._pf: Optional[_PrefillGroup] = None
        self.queue.clear()

    def warmup(self, prompt_lens: Sequence[int]) -> None:
        """Run the admission and decode shapes of the prompt buckets
        covering ``prompt_lens`` once (at both admission widths, 1 and
        ``slots``), reset, and capture the decode step's graph on the new
        resident cache.  This takes first-call set-up (library handles,
        allocator growth, the capture) out of the first requests'
        latency."""
        buckets = sorted({self.engine.prompt_bucket(int(n))
                          for n in prompt_lens})
        sink: List[RequestResult] = []
        rid = -1
        for b in buckets:
            prompt = np.ones((min(b, self.max_len - 2),), np.int32)
            for n in (1, min(self.slots + 1, self.slots * 2)):
                for j in range(n):
                    self.submit(Request(rid - j, prompt, 2))
                while self.has_work():
                    self.admit_ready(lambda: 0.0, sink)
                    self.step_prefill(lambda: 0.0, sink)
                    if any(s is not None for s in self._slot):
                        self.run_segment(lambda: 0.0, sink)
                rid -= n
        self.reset()
        self._segment_step()

    def _segment_step(self):
        """The segment's masked decode step over the resident cache:
        ``step(tok (B, 1), mask (B,)) -> logits (B, 1, V)``.  On the card a
        replay of its CUDA graph, captured on the first call after a
        reset (its warm-up steps have no active row, so they change
        nothing); on the CPU the step run eagerly."""
        e, caches = self.engine, self._caches

        def step(tok, mask):
            return decode_step(e.params, self.cfg, e.decode_flags, tok,
                               caches, active=mask)[0]

        if self.graphs is None:
            return step
        return self.graphs.step(
            step_key(self.cfg, e.decode_flags, self.slots, self.paged), step,
            caches, self.slots, masked=True)

    # -- decode segments ----------------------------------------------------

    @torch.inference_mode()
    def run_segment(self, clock, results: List[RequestResult]) -> None:
        """``seg_len`` decode steps over all slots.  Tokens stay on the
        device; a slot with r tokens left is active for its first
        min(r, seg_len) steps (the host knows which, so no step syncs, and
        a step in which no slot is active is not run; ``stats
        ["decode_steps"]`` counts the steps run).  Each step copies its
        mask row into the step's input and runs it (a graph replay on the
        card); each greedy slot takes the first maximum of the logits, each
        sampled slot draws from its own generator at its own temperature.
        One host sync at the end collects the segment's tokens."""
        remaining = np.asarray(
            [s.remaining if s else 0 for s in self._slot], np.int32)
        act = (self._active[None, :]
               & (remaining[None, :] > np.arange(self.seg_len)[:, None]))
        sampled = [i for i in range(self.slots)
                   if self._slot[i] is not None and not self._greedy[i]]
        t0 = time.monotonic()
        step = self._segment_step()
        act_dev = torch.as_tensor(act, device=self.device)  # one upload
        n_act = act.sum(axis=1)
        tok = self._tok
        outs = []
        steps = 0
        for t in range(self.seg_len):
            if n_act[t] == 0:             # no slot decodes: skip the step
                outs.append(tok)
                continue
            lg = step(tok, act_dev[t])[:, -1]
            steps += 1
            nxt = lg.argmax(dim=-1, keepdim=True)
            for i in sampled:
                if act[t, i]:
                    nxt[i:i + 1] = _sample(lg[i:i + 1], self._gens[i], False,
                                           self._temps[i])
            tok = torch.where(act_dev[t][:, None], nxt, tok)
            outs.append(tok)
        toks = torch.cat(outs, dim=1).cpu().numpy()   # the segment's sync
        self._tok = tok
        self._active = self._active & (remaining > self.seg_len)
        now = clock()
        self.stats["segments"] += 1
        self.stats["decode_steps"] += steps
        self.stats["segment_s"] += time.monotonic() - t0
        for i, st in enumerate(self._slot):
            if st is None:
                continue
            emitted = min(st.remaining, self.seg_len)
            st.collected.append(toks[i, :emitted].astype(np.int32))
            st.remaining -= emitted
            self.stats["useful_tokens"] += emitted
            if st.remaining == 0:
                self._emit(results, st.req, self._partial(st), st.admit_s,
                           now, first_s=st.first_token_s)
                self._retire_slot(i)

    # -- serving loops ------------------------------------------------------

    def run(self, requests: Sequence[Request]) -> Dict[int, np.ndarray]:
        """Deterministic drain (tests): queue everything, serve to empty,
        return {rid: tokens}.  Chunk bursts of an in-flight admission run
        between decode segments."""
        for r in requests:
            self.submit(r)
        results: List[RequestResult] = []
        clock = lambda: 0.0
        while self.has_work():
            self.admit_ready(clock, results)
            self.step_prefill(clock, results)
            if any(s is not None for s in self._slot):
                self.run_segment(clock, results)
        return {r.rid: r.tokens for r in results}

    def serve(self, workload: Sequence[Request]) -> List[RequestResult]:
        """Open-loop wall-clock serving: requests become visible at their
        ``arrival_s`` offsets; admission starts between segments and
        chunked prompt ingestion interleaves with them."""
        items = sorted(workload, key=lambda r: r.arrival_s)
        results: List[RequestResult] = []
        i = 0
        t0 = time.monotonic()
        clock = lambda: time.monotonic() - t0
        while i < len(items) or self.has_work():
            now = clock()
            while i < len(items) and items[i].arrival_s <= now:
                self.submit(items[i])
                i += 1
            self.admit_ready(clock, results)
            self.step_prefill(clock, results)
            if any(s is not None for s in self._slot):
                self.run_segment(clock, results)
            elif self._pf is None and not self.queue and i < len(items):
                time.sleep(max(0.0, min(items[i].arrival_s - now, 0.05)))
        return sorted(results, key=lambda r: r.rid)


# ---------------------------------------------------------------------------
# static-batch baseline + synthetic open-loop workloads
# ---------------------------------------------------------------------------


class StaticBatchServer:
    """The static serving pattern as a baseline: requests form fixed
    batches of ``batch_size`` in arrival order, prompts are right-padded
    to the batch max, ``Engine.generate`` runs with n_new = batch max, and
    every request waits for the whole batch."""

    def __init__(self, engine: Engine, batch_size: int):
        self.engine = engine
        self.batch_size = batch_size

    def serve(self, workload: Sequence[Request]) -> List[RequestResult]:
        items = sorted(workload, key=lambda r: r.arrival_s)
        results: List[RequestResult] = []
        t0 = time.monotonic()
        for k in range(0, len(items), self.batch_size):
            batch = items[k:k + self.batch_size]
            # the batch launches only once its last member has arrived
            gate = max(r.arrival_s for r in batch)
            wait = gate - (time.monotonic() - t0)
            if wait > 0:
                time.sleep(wait)
            lmax = max(len(r.prompt) for r in batch)
            mat = np.full((len(batch), lmax), self.engine.pad_id, np.int32)
            lengths = np.empty((len(batch),), np.int32)
            for j, r in enumerate(batch):
                mat[j, :len(r.prompt)] = r.prompt          # right-pad
                lengths[j] = len(r.prompt)
            n = max(r.n_new for r in batch)
            admit = time.monotonic() - t0
            res = self.engine.generate(mat, n, lengths=lengths)
            finish = time.monotonic() - t0
            for j, r in enumerate(batch):
                # tokens surface when the whole batch retires, so the
                # static baseline's TTFT is its full batch latency
                results.append(RequestResult(
                    r.rid, res.tokens[j, :r.n_new], len(r.prompt), r.n_new,
                    r.arrival_s, admit, finish, first_token_s=finish))
        return sorted(results, key=lambda r: r.rid)


def synthetic_workload(n_requests: int, *, rate_rps: float,
                       prompt_lens=(64, 512), n_new_range=(16, 256),
                       vocab: int = 512, seed: int = 0,
                       greedy: bool = True,
                       deadline_s: Optional[float] = None) -> List[Request]:
    """Open-loop Poisson arrivals with mixed request shapes: exponential
    gaps at ``rate_rps``, prompt lengths uniform over
    [prompt_lens[0], prompt_lens[1]], n_new uniform over n_new_range
    (numpy's generator from ``seed``: the reference's requests exactly)."""
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for rid in range(n_requests):
        t += float(rng.exponential(1.0 / rate_rps))
        plen = int(rng.integers(prompt_lens[0], prompt_lens[1] + 1))
        n = int(rng.integers(n_new_range[0], n_new_range[1] + 1))
        prompt = rng.integers(1, vocab - 4, size=(plen,)).astype(np.int32)
        out.append(Request(rid, prompt, n, greedy=greedy, seed=rid,
                           arrival_s=t, deadline_s=deadline_s))
    return out


def summarize(results: Sequence[RequestResult],
              wall_s: float) -> Dict[str, float]:
    """Serving metrics over the completed (``status == "ok"``) results:
    goodput (delivered new tokens per wall second), latency and
    time-to-first-token percentiles, per-status counts and the share of
    deadline-carrying results that met their budget.  Empty ``results``
    give zeroed metrics."""
    counts = {f"n_{s}": 0 for s in STATUSES}
    for r in results:
        counts[f"n_{r.status}"] += 1
    ok = [r for r in results if r.status == "ok"]
    budgeted = [r for r in ok if r.deadline_s is not None]
    slo = (round(sum(r.latency_s <= r.deadline_s for r in budgeted)
                 / len(budgeted), 4) if budgeted else 1.0)
    if not ok:
        out = {"n_requests": len(results), "delivered_tokens": 0,
               "wall_s": round(wall_s, 3), "goodput_tok_s": 0.0,
               "p50_latency_s": 0.0, "p95_latency_s": 0.0,
               "mean_latency_s": 0.0, "p50_ttft_s": 0.0,
               "p95_ttft_s": 0.0}
        out.update(counts)
        out["slo_attainment"] = slo
        return out
    lats = np.asarray([r.latency_s for r in ok])
    ttfts = np.asarray([r.ttft_s for r in ok])
    toks = sum(r.n_new for r in ok)
    out = {
        "n_requests": len(results),
        "delivered_tokens": int(toks),
        "wall_s": round(wall_s, 3),
        "goodput_tok_s": round(toks / max(wall_s, 1e-9), 2),
        "p50_latency_s": round(float(np.percentile(lats, 50)), 3),
        "p95_latency_s": round(float(np.percentile(lats, 95)), 3),
        "mean_latency_s": round(float(lats.mean()), 3),
        "p50_ttft_s": round(float(np.percentile(ttfts, 50)), 3),
        "p95_ttft_s": round(float(np.percentile(ttfts, 95)), 3),
    }
    out.update(counts)
    out["slo_attainment"] = slo
    return out
