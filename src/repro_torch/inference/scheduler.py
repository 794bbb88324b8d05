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
                  SWA archs, recurrent archs, and MoE archs under
                  ``moe_prefill="capacity"``): the group runs one
                  ``Engine.prefill`` while every resident decoder waits.
                  An SWA arch's resident cache is a dense ring of
                  min(max_len, window) rows per slot; the insert
                  zero-extends a prefill ring of min(prompt, window) rows
                  into it.  A recurrent arch (RWKV6, a Mamba hybrid)
                  buckets no prompt, so a group is requests of one
                  length; the insert overwrites every recurrent leaf of
                  the slot (``s``, ``x_prev``, ``ffn_prev``; ``h``,
                  ``conv``) with its prefill row, and zero-extends a
                  hybrid's attention rows as any other.  A masked decode
                  step leaves an inactive slot's recurrent leaves as
                  they are (models/ssm.py).
  paged cache     ``paged=True`` replaces the dense (slots, max_len) rows
                  by a page table over one shared pool (``PagePool`` keeps
                  the host's account; page 0 is the permanent zero page).
                  Pages are zeroed before they are mapped, so a slot's
                  logical view equals the dense zero-extended row.
  prefix reuse    a request declaring ``prefix_len`` (and a ``prefix_key``,
                  by default the SHA-1 of its int32 prefix tokens, as the
                  reference hashes them) shares the prefix's whole pages
                  copy-on-write with every request of the same key, prompt
                  bucket and mode (paged, chunked engines only).  The first
                  group of a key allocates and registers the pages, and its
                  members' inserts fill them; a later group (a registry
                  HIT) maps them, seeds its staging cache's first rows
                  from them (``_seed``: plain index copies on the device)
                  and skips those chunks.  The registry is LRU: an
                  unfundable admission evicts idle registrations first.
  per-request     ``Request.dsa_mode`` overrides the engine's DSA path on a
  modes           ``long_context`` engine.  Segments are mode-affine: one
                  segment runs one mode (a CUDA graph per mode over the one
                  resident cache), admission groups one mode, and the
                  engine switches modes when it drains idle, or, with
                  ``max_mode_wait_s``, when an other-mode request has
                  waited that long.
  speculation     ``spec=K`` (dense resident caches only, and only inside
                  ``speculative.can_speculate``): a segment runs
                  ``spec_rounds`` draft-and-verify rounds instead of
                  ``seg_len`` steps.  Each round drafts K tokens a slot
                  from the slot's token history (prompt, then every token
                  it emitted, kept in a buffer appended in place), runs one
                  verify forward and its commit (a graph replay each on
                  the card), and collects 1 to K + 1 tokens a slot.  A
                  segment whose mode is outside the envelope runs plain;
                  a proposer that raises costs that round's segment
                  (plain instead when no round ran) and three failures
                  in a row turn speculation off for the engine's life.

Token-exactness: a request served here gets the tokens of
``Engine(cfg, params, max_len=<same>).generate(prompt[None], n_new,
greedy=..., seed=..., temperature=...)``: chunked admission over a
bucket-sized staging cache reproduces the bucketed whole-prompt prefill
(same selection geometry), and each slot samples from its own
``torch.Generator`` seeded by ``Request.seed``, drawn once per token as
the B=1 chain of ``Engine.generate`` is.  Paged serving gives the dense
tokens; a request with ``dsa_mode`` set gets ``generate(...,
dsa_mode=...)``'s; a prefix hit gives the tokens of the same requests
undeclared, since the seeded rows are the bytes the skipped chunks write.
Speculative segments give each request its plain tokens (on tokens: a
verify product over C rows rounds otherwise than a step's, see
inference/speculative.py).  Pinned by tests/test_torch_scheduler.py,
tests/test_torch_prefix.py, tests/test_torch_modes.py and
tests/test_torch_spec.py.

Request lifecycle: every request retires with a typed
``RequestResult.status`` (``ok | timeout | cancelled | failed | shed``)
through one path (``_emit``).  Deadlines (``Request.deadline_s``, else
``ServingConfig.deadline_s``, on the serve clock: seconds since arrival)
and ``cancel(rid)`` retire queued, chunking or resident requests at
segment boundaries: a resident slot freezes through the ``active`` mask
and returns its pages as a normal retirement does, so co-resident slots
are bitwise untouched.  Overload sheds at a bounded queue (``queue_cap``,
``shed_policy``); an anchor the page pool cannot fund retries, and on an
otherwise idle engine is shed after ``admit_retries`` attempts.  A
non-finite logits row fails only its slot (``fin``, kept on the device
for every step and read at the segment's one sync); a draft proposer
that raises degrades speculative segments to plain ones; a
``StepWatchdog`` flags slow segments; ``health()`` snapshots it all.
Results made outside a call that carries a results list (a shed at
submit, ``cancel``) surface at the next admission point.

Faults (``ServingConfig.injector``, inference/faults.py): the injector
is consulted at five points (nan_logits, pool_exhaust, proposer,
slow_segment, dispatch); with none armed every consult is skipped and
the segments run exactly the steps they ran without it.  An exception
raised by a segment itself fails every in-flight request and rebuilds
the resident cache (``_scrub_all``): the graphs are dropped first, since
they hold the old cache's addresses, and captured again by the next
segment.  Only a fault that surfaces on the host as an exception can be
scrubbed so: a raise in the step, a refused launch, an out-of-memory
error at capture.  A sticky device fault (an illegal address, say)
leaves the CUDA context unusable, and no rebuild inside the process
recovers from it: the process must restart.

Telemetry (``ServingConfig.telemetry``, inference/telemetry.py; None records
nothing and runs no hook): request spans, segment, chunk-burst, admission
and fault events, Prometheus metrics fed from ``_emit`` and ``health()``,
compile events (each new shape signature of an eager entry point, each
graph capture on the card) and, once every ``sample_every`` segments, a
sparsity probe (``_sparsity_probe``): one eager decode step that reads
back each layer's block selection and puts back every cache row it
wrote.

Serving meshes (``ServingConfig.mesh``, launch/mesh.py): one process a
device, every rank running this engine on the same requests.  Under
data parallelism ("data") the resident cache holds this rank's slots
[lo, hi) (``Engine.local_rows``; every slot when the data axis does not
divide them), each segment decodes them, and its one sync becomes one
all-gather over "data" of every slot's tokens and finiteness flag, so
every rank's host state (slots, queue, page-pool account) stays the
same; a speculative round gathers its drawn tokens and emit counts.
Admission runs replicated over "data" (every rank chunks or prefills
the whole group into its own staging cache, and the first tokens every
rank acts on are data rank 0's); the insert writes only the slot's
rank.  A paged pool is the whole pool on every rank: inserts write its
pages everywhere (a shared prefix page may back any rank's slot), the
decode steps only their own slots' pages.  Under tensor parallelism
("model") the weights, the K/V rows and the pool's head axis are this
rank's shard and the layers all-reduce (models/); the kt/ktb selection
caches stay whole.  Every ``dsa_mode`` is served, ``faithful``
included.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.quantization import raw
from repro_torch.distributed import collectives as C
from repro_torch.distributed.fault_tolerance import StepWatchdog
from repro_torch.inference.config import ServingConfig, resolve_config
from repro_torch.inference.engine import (Engine, _ro_view, _sample, _sync,
                                          can_chunk_prefill, can_page,
                                          pow2_bucket)
from repro_torch.inference.faults import FaultError
from repro_torch.inference.graphs import step_key
from repro_torch.inference.speculative import (NGramProposer,
                                               SpeculativeDecoder,
                                               can_speculate)
from repro_torch.inference.telemetry import probe_ok
from repro_torch.models.attention import (DSA_MODES, _pool_write,
                                          cache_page_size)
from repro_torch.models.transformer import (attn_caches, chunk_step,
                                            decode_step, init_cache)

# cache leaves with a per-token (or per-block) row axis after the batch
# axis, quantization scales included: zero-extended from the staging
# bucket to the resident length at insertion
_SEQ_KEYS = ("k", "v", "kt", "ktb", "k_s", "v_s", "kt_s", "ktb_s", "c_kv",
             "k_rope")
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
    dsa_mode: Optional[str] = None  # override the engine's DSA path
    # copy-on-write prefix sharing (paged engines): the first prefix_len
    # prompt tokens are shared with every request of the same prefix_key
    # (submit hashes the prefix tokens when it is None)
    prefix_len: int = 0
    prefix_key: Optional[str] = None
    # lifecycle: latency budget in seconds since arrival (None: the
    # engine's ServingConfig.deadline_s), and the shedding priority under
    # overload (higher survives "lowest-priority")
    deadline_s: Optional[float] = None
    priority: int = 0

    def __post_init__(self):
        if self.dsa_mode is not None and self.dsa_mode not in DSA_MODES:
            raise ValueError(
                f"Request.dsa_mode={self.dsa_mode!r} is not a valid DSA "
                f"mode; valid: {DSA_MODES} (or None for the engine default)")


# the typed retirement statuses: "ok" delivered all n_new tokens; the rest
# surface partial (timeout/cancelled/failed: whatever was collected before
# the slot froze) or empty (shed, never admitted) token arrays
STATUSES = ("ok", "timeout", "cancelled", "failed", "shed")


@dataclasses.dataclass
class RequestResult:
    rid: int
    tokens: np.ndarray            # (n_new,) when status == "ok", else fewer
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
    # the slot's token history (prompt, tok0, then every collected
    # token), appended in place: draft proposers read a view of it each
    # round instead of a re-concatenation of the whole context
    history: Optional[np.ndarray] = None
    hist_len: int = 0

    def extend_history(self, toks: np.ndarray) -> None:
        n = toks.shape[0]
        self.history[self.hist_len:self.hist_len + n] = toks
        self.hist_len += n


@dataclasses.dataclass
class _PrefillGroup:
    """An in-flight chunked admission: one same-bucket, same-mode group
    streaming through a bucket-sized staging cache."""
    reqs: List[Request]
    slots: List[Optional[int]]    # reserved resident slot per member
    bucket: int
    chunk: int                    # chunk width (min(chunk_tokens, bucket))
    mode: str                     # effective dsa_mode
    caches: object                # staging cache (dense, bpf rows)
    lengths: np.ndarray           # (bpf,) true prompt length per row
    j: int = 0                    # next chunk index
    n_chunks: int = 0
    mat: Optional[np.ndarray] = None   # (bpf, n_chunks*chunk) padded tokens
    tbls: Optional[List] = None   # paged: per-member page-table row
    # members no longer chunking: finished (activated or retired at their
    # first token) or cancelled/expired mid-chunk.  A dead row keeps
    # chunking (the group's geometry is fixed) but never activates
    dead: Set[int] = dataclasses.field(default_factory=set)
    # the prefix registration this group made on a registry miss, until a
    # member's insert has filled its pages (None after that)
    reg_key: Optional[tuple] = None


def _step_targets(lc: Dict, bk: int) -> Tuple[tuple, tuple]:
    """The entries a decode step may write in a layer's cache ``lc``, as
    index tuples: each row's token row (k, v, kt and their scales) and
    its block row (ktb, ktb_s).  Dense: row b's slot at its ``pos`` and
    that slot's block.  Paged: the pool row and page its ``pos`` maps to,
    and the zero page's first row, where a write that does not land puts
    zeros."""
    pos = lc["pos"].long()
    rows = torch.arange(pos.shape[0], device=pos.device)
    if "page_tbl" in lc:
        tbl = lc["page_tbl"].long()
        pg = tbl[rows, (pos // bk).clamp(0, tbl.shape[1] - 1)]
        zero = torch.zeros((1,), dtype=torch.long, device=pos.device)
        return (torch.cat([pg * bk + pos % bk, zero]),), (torch.cat([pg,
                                                                     zero]),)
    s = lc["k"].shape[1]
    slot = torch.where(pos < s, pos, pos % s)
    return (rows, slot), (rows, slot // bk)


def _save_step_rows(lc: Dict, bk: int) -> Tuple[Optional[tuple], Dict]:
    """What a decode step will overwrite in ``lc``: ``pos`` and the
    entries ``_step_targets`` names, copied (a few rows a layer); a
    recurrent layer's leaves whole (its state, a few MiB a layer)."""
    if "pos" not in lc:
        return None, {name: t.clone() for name, t in lc.items()}
    at_row, at_blk = _step_targets(lc, bk)
    saved = {"pos": lc["pos"].clone()}
    for keys, at in ((_POOL_ROW_KEYS, at_row), (_POOL_PAGE_KEYS, at_blk)):
        for name in keys:
            if name in lc:
                saved[name] = raw(lc[name])[at].clone()
    return (at_row, at_blk), saved


def _restore_step_rows(lc: Dict, saved: Tuple[tuple, Dict]) -> None:
    """Put back what ``_save_step_rows`` copied (repeated targets all hold
    the same original bytes, so their order does not matter)."""
    at, vals = saved
    if at is None:
        for name, v in vals.items():
            lc[name].copy_(v)
        return
    at_row, at_blk = at
    for keys, at in ((_POOL_ROW_KEYS, at_row), (_POOL_PAGE_KEYS, at_blk)):
        for name in keys:
            if name in lc:
                raw(lc[name])[at] = vals[name]
    lc["pos"].copy_(vals["pos"])


class PagePool:
    """Host-side account of a PAGED resident cache's physical pages.

    The device holds a flat pool of ``n_pages`` pages of ``page_rows``
    rows, indirected per slot through ``page_tbl``; this mirror decides
    which pages back which slot.  Page 0 is the permanent zero page,
    never allocated.  Invariant: every page in [1, n_pages) is either on
    the free stack or has refcount > 0, never both.  A refcount passes 1
    only for a copy-on-write shared prefix page: the prefix registry holds
    one reference and each slot mapping the prefix another, so a retiring
    slot returns exactly its private pages and a registered prefix
    outlives its readers.  Pages freed with data in them land in
    ``dirty`` and are zeroed on the device before their next mapping
    (``take_dirty``).

    ``prefixes`` is the LRU registry (prefix_key, prefix_len, bucket,
    mode) -> shared pages; it lives in the cache, so ``reset`` (and
    ``_scrub_all``) rebuild it with the pool."""

    def __init__(self, n_pages: int, page_rows: int):
        if n_pages < 2:
            raise ValueError(f"a pool needs the zero page and one more; "
                             f"got {n_pages} pages")
        self.n_pages = n_pages
        self.page_rows = page_rows
        self.free: List[int] = list(range(n_pages - 1, 0, -1))
        self.ref = np.zeros((n_pages,), np.int32)
        self.slot_pages: Dict[int, Tuple[List[int], int]] = {}
        self.dirty: Set[int] = set()
        self.prefixes: "OrderedDict[tuple, List[int]]" = OrderedDict()

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

    def retain(self, pages: Sequence[int]) -> None:
        for p in pages:
            self.ref[p] += 1

    def release(self, pages: Sequence[int]) -> None:
        for p in pages:
            self.ref[p] -= 1
            if self.ref[p] < 0:
                raise RuntimeError(f"page {p} over-released")
            if self.ref[p] == 0:
                self.free.append(p)
                self.dirty.add(p)

    def assign_slot(self, slot: int, pages: Sequence[int],
                    n_shared: int = 0) -> None:
        """``pages``: the slot's whole table, its first ``n_shared`` the
        shared prefix pages (retained by the caller)."""
        self.slot_pages[slot] = (list(pages), n_shared)

    def free_slot(self, slot: int) -> None:
        pages, _ = self.slot_pages.pop(slot)
        self.release(pages)

    def take_dirty(self, pages: Sequence[int]) -> List[int]:
        """The subset of ``pages`` needing a device zero before use;
        marks them clean."""
        d = [p for p in pages if p in self.dirty]
        self.dirty.difference_update(d)
        return d

    # -- copy-on-write prefix registry (LRU) --------------------------------

    def lookup_prefix(self, key) -> Optional[List[int]]:
        pages = self.prefixes.get(key)
        if pages is not None:
            self.prefixes.move_to_end(key)     # LRU refresh
        return pages

    def register_prefix(self, key, pages: Sequence[int]) -> None:
        """The registry takes over ``alloc``'s reference."""
        self.prefixes[key] = list(pages)

    def evict_for(self, n: int, keep=None) -> None:
        """Evict registrations, least recently used first and never
        ``keep``, until ``n`` pages are free or none is left.  An evicted
        page that a live slot still maps frees at that slot's
        retirement."""
        while len(self.free) < n:
            key = next((k for k in self.prefixes if k != keep), None)
            if key is None:
                return
            self.release(self.prefixes.pop(key))


class ContinuousEngine:
    """Resident continuous-batching engine (see module docstring)."""

    def __init__(self, cfg: ArchConfig, params, *,
                 config: Optional[ServingConfig] = None, device=None, **kw):
        """``config`` (or keyword arguments, which are ServingConfig
        fields) as for ``Engine``; ``device=None`` means the card."""
        c = resolve_config(config, kw)
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
        self.mesh = self.engine.mesh
        # under a data-parallel mesh the resident cache holds this rank's
        # slots [lo, hi) (every slot when the data axis does not divide
        # them); the host state (queue, slots, pool account) is the whole
        # engine's on every rank
        rows = self.engine.local_rows(slots)
        self._lo, self._hi = rows.start, rows.stop
        self._world = C.world_group(self.mesh)
        # chunked admission replays the bucketed whole-prompt prefill;
        # SWA and recurrent archs admit blocking (their prompts are not
        # bucketed), and MoE archs unless moe_prefill="dense" routes their
        # prefill through the decode-dense expert path
        chunk_ok = self.engine.bucket_prompts and can_chunk_prefill(
            cfg, self.engine.decode_flags.dsa_mode,
            moe_dense=self.engine.moe_dense)
        self.chunked = chunk_ok if c.chunked_prefill is None else (
            c.chunked_prefill and chunk_ok)
        self.paged = c.paged
        if self.paged:
            if not can_page(cfg):
                raise ValueError(
                    f"paged=True: {cfg.name} is outside the paging envelope "
                    f"(needs a pure-attention decoder: no ssm/rwkv/swa/mla/"
                    f"enc-dec/cross-attn)")
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
        # mode-affine aging: an other-mode request queued this long forces
        # a drain and a mode switch (None: wait for an idle drain)
        self.max_mode_wait_s = c.max_mode_wait_s
        # speculative segments: off outside the envelope and on a paged
        # cache (the verify writes dense rows), as in the reference
        dsa_mode = self.engine.decode_flags.dsa_mode
        self.spec = c.spec if (c.spec and not self.paged and can_speculate(
            cfg, dsa_mode, c.spec)) else 0
        self.draft = (c.draft if c.draft is not None else NGramProposer()
                      ) if self.spec else None
        # rounds a speculative segment: a fully accepted one emits about
        # one plain segment's tokens
        self.spec_rounds = (c.spec_rounds if c.spec_rounds is not None
                            else max(1, self.seg_len // (self.spec + 1))
                            ) if self.spec else 0
        self._spec = SpeculativeDecoder(self.spec) if self.spec else None
        # fault tolerance: bounded admission queue and shed policy, default
        # latency budget, unfundable-anchor retry bound, fault injector
        # (public and mutable: it never enters a graph, so tests swap it
        # between runs on one engine)
        self.queue_cap = c.queue_cap
        self.shed_policy = c.shed_policy
        self.deadline_s = c.deadline_s
        self.admit_retries = c.admit_retries
        self.injector = c.injector
        # telemetry=None records nothing and runs no hook.  With a
        # Telemetry, every eager entry point records its new shape
        # signatures (``_note``; the inner engine records its own from the
        # same config, and its graphs record their captures), and the
        # request lifecycle and the segment, chunk and fault events land
        # on the trace
        self.telemetry = c.telemetry
        self._probe_prev: Dict[int, tuple] = {}   # slot -> (rid, blocks)
        if self.telemetry is not None:
            self.telemetry.bind_engine(self)
        self.queue: deque = deque()
        self.graphs = self.engine.graphs  # the engine's graphs, one a key
        self.reset()

    # -- queue / admission --------------------------------------------------

    def _eff_mode(self, req: Request) -> str:
        return (req.dsa_mode if req.dsa_mode is not None
                else self.engine.decode_flags.dsa_mode)

    def _flags(self, mode: str):
        """The decode and chunk-step flags of a dsa_mode."""
        return self.engine.run_flags("decode", mode)

    def _pages_needed(self, req: Request) -> int:
        return -(-(len(req.prompt) + req.n_new) // self._page_rows)

    def _prefix_ctx(self, req: Request, bucket: int, mode: str,
                    chunked: bool):
        """(registry key, whole shared pages) of a request's declared
        prefix in this group's geometry; (None, 0) when it declares none,
        the prefix spans no whole page, or the group admits blocking
        (seeding needs the staging cache)."""
        if not (self.paged and chunked and req.prefix_key
                and req.prefix_len):
            return None, 0
        n_sh = req.prefix_len // self._page_rows
        if n_sh == 0:
            return None, 0
        return (req.prefix_key, req.prefix_len, bucket, mode), n_sh

    def _note(self, program: str, *args) -> None:
        """An eager call of ``program`` with ``args``: a compile event
        when telemetry is on and the signature is new."""
        if self.telemetry is not None:
            self.telemetry.note(program, *args)

    def _agree(self, value: float) -> float:
        """Rank 0's ``value`` on every rank of the mesh (``value`` without
        one): a host decision from a local clock or timing must be every
        rank's, or their collectives fall out of step."""
        return C.agree(value, self._world, self.device)

    @torch.inference_mode()
    def _zero_pages(self, ids: Sequence[int]) -> None:
        """Zero pool pages ``ids`` in every pool leaf of every layer, so a
        freshly mapped page reads as zeros."""
        self._note("zero_pages", ids)
        bk = self._page_rows
        ids = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        rows = (ids[:, None] * bk + torch.arange(
            bk, device=self.device)[None, :]).reshape(-1)
        for lc in attn_caches(self._caches):
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
            if not 0 < req.prefix_len <= plen:
                raise ValueError(
                    f"request {req.rid}: prefix_len {req.prefix_len} "
                    f"outside (0, prompt_len {plen}]")
            if req.prefix_key is None:
                # equal declared prefixes match without the callers
                # agreeing on keys (the reference's hash, so keys agree
                # across the two packages)
                req.prefix_key = hashlib.sha1(np.ascontiguousarray(
                    np.asarray(req.prompt, np.int32)[:req.prefix_len]
                ).tobytes()).hexdigest()
        if req.dsa_mode is not None:
            allowed = (set(DSA_MODES)
                       if self.engine.decode_flags.long_context
                       else {self.engine.decode_flags.dsa_mode})
            if req.dsa_mode not in allowed:
                raise ValueError(
                    f"request {req.rid}: dsa_mode {req.dsa_mode!r} needs a "
                    f"cache layout this engine doesn't hold ({allowed})")
        if self.paged and self._pages_needed(req) > self.pool_pages - 1:
            raise ValueError(
                f"request {req.rid}: needs {self._pages_needed(req)} cache "
                f"pages but the pool holds {self.pool_pages - 1} "
                f"allocatable pages — raise pool_pages or shorten it")
        if (self.queue_cap is not None
                and len(self.queue) >= self.queue_cap):
            victim = self._shed_victim(req)
            if victim is not None:
                # a shed request never touched a slot: empty tokens, admit
                # == finish == arrival (no wall clock involved)
                self._emit(None, victim, np.zeros((0,), np.int32),
                           victim.arrival_s, victim.arrival_s, "shed")
                if victim is req:
                    return
        self._live.add(req.rid)
        self._enq_s[req.rid] = time.monotonic()
        self.queue.append(req)
        if self.telemetry is not None:
            self.telemetry.on_submit(req.rid, len(self.queue))

    def free_slots(self) -> List[int]:
        return [i for i in range(self.slots)
                if self._slot[i] is None and i not in self._reserved]

    def has_work(self) -> bool:
        return (bool(self.queue) or self._pf is not None
                or any(s is not None for s in self._slot))

    def _next_admissible(self) -> Optional[int]:
        """Queue index of the first request admissible under the current
        segment mode (any request when the engine is idle): segments are
        mode-affine, so other-mode requests wait for an idle drain.

        Aging (``max_mode_wait_s``): once an other-mode request has been
        queued that long, admission stops (None) until the engine drains;
        at the idle switch the queue's order puts it first.  Without aging
        sustained same-mode traffic can starve it."""
        if not self.queue:
            return None
        if self._pf is None and not any(s is not None for s in self._slot):
            self._cur_mode = None         # idle: free to switch dsa_mode
        if self._cur_mode is None:
            return 0
        if self.max_mode_wait_s is not None:
            now = time.monotonic()
            if self._agree(any(self._eff_mode(r) != self._cur_mode
                               and now - self._enq_s.get(r.rid, now)
                               >= self.max_mode_wait_s
                               for r in self.queue)):
                return None               # an aged other-mode request
        for i, r in enumerate(self.queue):
            if self._eff_mode(r) == self._cur_mode:
                return i
        return None

    def _group_for_admission(self, k: int, anchor: int) -> List[Request]:
        """Pop up to ``k`` queued requests sharing the anchor's prompt
        bucket, dsa_mode and declared (prefix_key, prefix_len), for one
        shared prefill batch (a row's prefill must be the one a solo
        ``Engine.generate`` at that bucket and mode runs).  Skipped
        requests keep their order.

        A paged engine also caps the group at what the pool can fund now:
        shared prefix pages cost nothing on a registry hit, and on a miss
        the first slotted member pays for them.  An unfundable anchor (or
        one the injector's ``pool_exhaust`` makes so) first evicts idle
        registrations (LRU), then retries: with work resident or chunking
        it waits, with the whole queue, for retirements to return pages;
        on an otherwise idle engine nothing will, and it is shed after
        ``admit_retries`` attempts."""
        rest: deque = deque()
        for _ in range(anchor):
            rest.append(self.queue.popleft())
        first = self.queue.popleft()
        b0 = self.engine.prompt_bucket(len(first.prompt))
        m0 = self._eff_mode(first)
        budget = None
        if self.paged:
            use_chunked = self.chunked and can_chunk_prefill(
                self.cfg, m0, moe_dense=self.engine.moe_dense)
            key0, n_sh = self._prefix_ctx(first, b0, m0, use_chunked)
            hit = (key0 is not None
                   and self.pool.lookup_prefix(key0) is not None)
            shared_pending = 0 if hit else n_sh

            def cost(r):
                if r.n_new <= 1:
                    return 0              # never slotted: staging only
                return self._pages_needed(r) - n_sh + shared_pending

            if self.injector is not None:
                self.injector.telemetry = self.telemetry
            forced = (self.injector is not None
                      and self.injector.take("pool_exhaust") is not None)
            need0 = cost(first)
            if not forced and need0 > self.pool.available():
                self.pool.evict_for(need0, keep=key0)
            if forced or need0 > self.pool.available():
                n = self._unfundable.get(first.rid, 0) + 1
                self._unfundable[first.rid] = n
                if (n > self.admit_retries and self._pf is None
                        and not any(s is not None for s in self._slot)):
                    self._emit(None, first, np.zeros((0,), np.int32),
                               first.arrival_s, first.arrival_s, "shed")
                else:
                    rest.append(first)
                while rest:
                    self.queue.appendleft(rest.pop())
                return []
            self._unfundable.pop(first.rid, None)
            budget = self.pool.available() - need0
            if first.n_new > 1:
                shared_pending = 0
        group = [first]
        while self.queue and len(group) < k:
            r = self.queue.popleft()
            if (self.engine.prompt_bucket(len(r.prompt)) == b0
                    and self._eff_mode(r) == m0
                    and (r.prefix_key, r.prefix_len)
                    == (first.prefix_key, first.prefix_len)):
                if budget is not None:
                    c = cost(r)
                    if c > budget:
                        rest.append(r)
                        continue
                    budget -= c
                    if r.n_new > 1:
                        shared_pending = 0
                group.append(r)
            else:
                rest.append(r)
        while rest:
            self.queue.appendleft(rest.pop())
        for r in group:                   # admitted: drop their aging stamps
            self._enq_s.pop(r.rid, None)
        return group

    def _first_tokens(self, last: torch.Tensor, reqs: Sequence[Request]
                      ) -> List[Tuple[int, torch.Generator]]:
        """Each request's first token from its prefill logits row of
        ``last`` (n, V), with a generator of its own seeded as
        ``Engine.generate`` seeds.  Admission runs replicated over a
        data-parallel mesh; the tokens every rank acts on are data rank
        0's (one all-gather over "data")."""
        out = []
        for i, req in enumerate(reqs):
            gen = torch.Generator(device=self.device).manual_seed(req.seed)
            tok0 = _sample(last[i:i + 1], gen, req.greedy, req.temperature)
            out.append((tok0, gen))
        toks = torch.cat([t for t, _ in out], dim=1) if out else None
        g = self.engine._dp
        if toks is not None and g is not None and g.size > 1:
            toks = C.all_gather(toks, g, 0)[:1]
        host = [] if toks is None else toks[0].tolist()
        return [(int(t), gen) for t, (_, gen) in zip(host, out)]

    def _activate(self, slot: int, req: Request, tok0: int,
                  gen: torch.Generator, admit_s: float,
                  first_s: float) -> None:
        if self._lo <= slot < self._hi:
            self._tok[slot - self._lo, 0] = tok0
        self._gens[slot] = gen
        self._active[slot] = True
        self._greedy[slot] = req.greedy
        self._temps[slot] = req.temperature
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        hist = np.empty((prompt.size + req.n_new,), np.int32)
        hist[:prompt.size] = prompt
        hist[prompt.size] = tok0
        self._slot[slot] = _SlotState(req, tok0, [], req.n_new - 1, admit_s,
                                      first_token_s=first_s, history=hist,
                                      hist_len=prompt.size + 1)
        if self.telemetry is not None:
            self.telemetry.on_first_token(req.rid)

    @torch.inference_mode()
    def _insert(self, pre, slot: int, row: int) -> None:
        """Overwrite resident slot ``slot`` with row ``row`` of a
        bucket-sized staging cache, every leaf: the per-token rows
        zero-extended (a ring of min(prompt, window) rows into one of
        min(max_len, window): both place token i at slot i % window),
        ``pos`` and a recurrent layer's state copied whole.  Under a
        data-parallel mesh the staging cache is every rank's (admission
        runs replicated over "data") and only the slot's rank writes."""
        if not self._lo <= slot < self._hi:
            return
        self._note("insert", pre, slot, row)
        for res, st in zip(attn_caches(self._caches), attn_caches(pre)):
            for name, t in res.items():
                src = raw(st[name])[row]
                dst = raw(t)[slot - self._lo]
                if name in _SEQ_KEYS:
                    dst.zero_()
                    dst[:src.shape[0]] = src
                else:
                    dst.copy_(src)

    @torch.inference_mode()
    def _insert_paged(self, pre, slot: int, row: int,
                      tbl_row: np.ndarray) -> None:
        """Paged slot insert: write row ``row`` of a dense staging cache
        into the pages ``tbl_row`` maps and install the page-table row.
        Staged rows whose block is unmapped (beyond the slot's pages, all
        zero) are dropped; mapped pages were zeroed at allocation, so the
        slot's logical view equals the dense zero-extended insert.  Under
        a data-parallel mesh every rank keeps the whole pool and writes
        the pages (a shared prefix page may be read by any rank's slot);
        the table row and ``pos`` land on the slot's rank."""
        self._note("insert_paged", pre, slot, row, tbl_row)
        bk = self._page_rows
        tbl = torch.as_tensor(tbl_row, dtype=torch.long, device=self.device)
        for res, st in zip(attn_caches(self._caches), attn_caches(pre)):
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
            if self._lo <= slot < self._hi:
                res["page_tbl"][slot - self._lo] = tbl.to(torch.int32)
                res["pos"][slot - self._lo] = st["pos"][row]

    def _admit_group(self, slots: List[int], group: List[Request], mode: str,
                     clock, results: List[RequestResult]) -> None:
        """BLOCKING admission: prefill a same-bucket, same-mode group in one
        padded whole-prompt batch (``Engine.prefill`` under ``mode``) and
        insert each row into a free slot (paged: private pages only, no
        prefix sharing).  Two batch widths per bucket (1 row for a single
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
        tel = self.telemetry
        tt0 = tel.now() if tel is not None else 0.0
        last, pcaches, tp = self.engine.prefill(mat, lengths=lengths,
                                                cache_len=bucket,
                                                dsa_mode=mode)
        if tel is not None:
            tel.on_admission(tt0, tp, len(group), bucket, mode,
                             kind="blocking")
        self.stats["prefill_s"] += tp
        if any(s is not None for s in self._slot):
            self.stats["stall_s"] += tp       # resident decoders sat idle
        self.stats["admitted"] += len(group)
        now = clock()
        free = iter(slots)
        first = self._first_tokens(last[:len(group), -1], group)
        for j, req in enumerate(group):
            tok0, gen = first[j]
            self.stats["useful_tokens"] += 1
            if req.n_new == 1:       # first token IS the whole generation
                if tel is not None:
                    tel.on_first_token(req.rid)
                self._emit(results, req, np.asarray([tok0], np.int32),
                           now, now, "ok", first_s=now)
                continue
            slot = next(free)
            if self.paged:
                npt = self._pages_needed(req)
                pages = self.pool.alloc(npt)
                self._zero_dirty(pages)
                self.pool.assign_slot(slot, pages, 0)
                row = np.zeros((self._n_kb,), np.int32)
                row[:npt] = pages
                self._insert_paged(pcaches, slot, j, row)
            else:
                self._insert(pcaches, slot, j)
            self._activate(slot, req, tok0, gen, now, now)

    # -- chunked admission (default) ----------------------------------------

    def _start_chunked_group(self, free: List[int], group: List[Request],
                             mode: str) -> None:
        """Begin streaming a same-bucket, same-mode group through a fresh
        bucket-sized staging cache; resident slots (and, paged, their
        pages) are reserved now and filled as each member's prompt
        completes.

        Paged, with a declared prefix: on a registry MISS with a slotted
        member the shared pages are allocated, zeroed and registered now,
        and the members' inserts fill them (each writes the same bytes:
        same prefix, same staging geometry; single-flight admission fills
        them before a HIT group can start).  On a HIT every member maps
        them, the staging cache is seeded from them and the group starts
        past the whole prefix chunks, capped so that every member still
        runs its finishing chunk, where its first token is sampled."""
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
        caches = init_cache(self.engine.mcfg, bpf, bucket,
                            self.engine.decode_flags,
                            dtype=self.engine.cache_dtype, device=self.device)
        slots: List[Optional[int]] = []
        it = iter(free)
        for r in group:
            slot = next(it) if r.n_new > 1 else None
            if slot is not None:
                self._reserved.add(slot)
            slots.append(slot)
        tbls = None
        skip = 0
        reg_key = None
        if self.paged:
            key, n_sh = self._prefix_ctx(group[0], bucket, mode, True)
            shared = self.pool.lookup_prefix(key) if key else None
            hit = shared is not None
            if not hit and key is not None and any(
                    s is not None for s in slots):
                shared = self.pool.alloc(n_sh)
                self._zero_dirty(shared)
                self.pool.register_prefix(key, shared)
                reg_key = key
            tbls = []
            for r, slot in zip(group, slots):
                if slot is None:
                    tbls.append(None)     # staging-only member: no pages
                    continue
                npt = self._pages_needed(r)
                if shared is not None:
                    self.pool.retain(shared)
                    priv = self.pool.alloc(npt - n_sh)
                    self._zero_dirty(priv)
                    pages = list(shared) + priv
                    self.pool.assign_slot(slot, pages, n_sh)
                else:
                    pages = self.pool.alloc(npt)
                    self._zero_dirty(pages)
                    self.pool.assign_slot(slot, pages, 0)
                row = np.zeros((self._n_kb,), np.int32)
                row[:len(pages)] = pages
                tbls.append(row)
            if hit:
                skip = min(n_sh * self._page_rows // c,
                           min(-(-len(r.prompt) // c) for r in group) - 1)
                if skip > 0:
                    self._seed(caches, shared[:skip * c // self._page_rows],
                               skip * c)
                self.stats["prefix_hits"] += len(group)
                self.stats["prefix_tokens_reused"] += skip * c * len(group)
        self._pf = _PrefillGroup(group, slots, bucket, c, mode, caches,
                                 lengths, j=skip, n_chunks=n_chunks, mat=mat,
                                 tbls=tbls, reg_key=reg_key)
        self.stats["admitted"] += len(group)
        if self.telemetry is not None:
            self.telemetry.on_admission(self.telemetry.now(), 0.0,
                                        len(group), bucket, mode,
                                        kind="chunked",
                                        prefix_skip_chunks=skip)

    @torch.inference_mode()
    def _seed(self, staging, pages: Sequence[int], r_rows: int) -> None:
        """Seed every row of a staging cache with the pool's shared-prefix
        ``pages`` (a registry HIT): their rows go to the first ``r_rows``
        rows (k, v, kt and their scales), their block rows to the first
        blocks (ktb, ktb_s), and ``pos`` becomes ``r_rows``: the staging
        state after chunking rows [0, r_rows), the chunks the group then
        skips.  Index copies on the device, no host sync."""
        self._note("seed", staging, pages, r_rows)
        bk = self._page_rows
        ids = torch.as_tensor(list(pages), dtype=torch.long,
                              device=self.device)
        rows = (ids[:, None] * bk + torch.arange(
            bk, device=self.device)[None, :]).reshape(-1)
        for res, st in zip(attn_caches(self._caches), attn_caches(staging)):
            for keys, at in ((_POOL_ROW_KEYS, rows), (_POOL_PAGE_KEYS, ids)):
                for name in keys:
                    if name in st:
                        raw(st[name])[:, :at.shape[0]] = raw(res[name])[at]
            st["pos"].fill_(r_rows)

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
            # a local timing: every rank of a mesh takes rank 0's
            return int(self._agree(np.clip(
                round(per_seg / max(per_chunk, 1e-9)), 1, remaining)))
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
        flags = self._flags(pf.mode)
        self._note("chunk", toks, pf.caches, cl, flags, pf.bucket)
        logits, _ = chunk_step(self.engine.params, self.engine.mcfg, flags,
                               toks, pf.caches, cl, sel_len=pf.bucket,
                               last=cl.long().clamp(min=1) - 1)
        return logits[:, 0]

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
                         if -(-len(r.prompt) // pf.chunk) == j + 1
                         and i not in pf.dead]
            if not finishing:
                continue
            _sync(self.device)            # this chunk has completed
            synced = True
            now = clock()
            first = self._first_tokens(last[finishing],
                                       [pf.reqs[i] for i in finishing])
            for i, (tok0, gen) in zip(finishing, first):
                req = pf.reqs[i]
                pf.dead.add(i)            # no longer chunking
                self.stats["useful_tokens"] += 1
                if req.n_new == 1:        # retires without touching a slot
                    if self.telemetry is not None:
                        self.telemetry.on_first_token(req.rid)
                    self._emit(results, req, np.asarray([tok0], np.int32),
                               now, now, "ok", first_s=now)
                    continue
                slot = pf.slots[i]        # early activation: decode now
                if self.paged:
                    self._insert_paged(pf.caches, slot, i, pf.tbls[i])
                else:
                    self._insert(pf.caches, slot, i)
                pf.reg_key = None         # the shared pages are written
                self._reserved.discard(slot)
                self._activate(slot, req, tok0, gen, now, now)
        if not synced:
            _sync(self.device)
        dt = time.monotonic() - t0
        self.stats["chunks"] += burst
        self.stats["chunk_s"] += dt
        if stalled:
            self.stats["stall_s"] += dt
        if self.telemetry is not None:
            self.telemetry.on_chunk_burst(dt, burst, pf.bucket, pf.mode,
                                          len(pf.reqs))
        if pf.j >= pf.n_chunks:
            self._pf = None               # every member inserted already

    @torch.inference_mode()
    def admit_ready(self, clock, results: List[RequestResult]) -> None:
        """Admit queued requests into free slots.  ``clock``: zero-arg
        callable giving seconds since serve start.  Chunked mode only
        STARTS a group here (one in flight at a time); its chunks run in
        ``step_prefill`` between decode segments.  Results made outside a
        call that carries ``results`` (sheds at submit, ``cancel``) are
        flushed here first, then deadline-expired work is reaped."""
        if self._pending:
            results.extend(self._pending)
            self._pending.clear()
        self._reap(clock, results)
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
            mode = self._eff_mode(group[0])
            self._cur_mode = mode
            # a per-request dsa_mode override can leave the chunk envelope
            # (DSA over MLA): such groups fall back to blocking admission
            if self.chunked and can_chunk_prefill(
                    self.cfg, mode, moe_dense=self.engine.moe_dense):
                self._start_chunked_group(free, group, mode)
                break
            self._admit_group(free, group, mode, clock, results)

    # -- request lifecycle (deadlines / cancellation / shedding) ------------

    def _eff_deadline(self, req: Request) -> Optional[float]:
        return (req.deadline_s if req.deadline_s is not None
                else self.deadline_s)

    def _emit(self, results: Optional[List[RequestResult]], req: Request,
              tokens, admit_s: float, finish_s: float, status: str,
              first_s: float = 0.0) -> None:
        """Retire ``req`` with a typed result, the single retirement path:
        its rid becomes reusable, a non-ok status is counted in ``stats``,
        telemetry sees every result once, and the result goes to
        ``results``, or to ``_pending`` (flushed at the next admission
        point) when the caller carries no list."""
        self._live.discard(req.rid)
        self._enq_s.pop(req.rid, None)
        self._unfundable.pop(req.rid, None)
        if status != "ok":
            self.stats[status] += 1
        res = RequestResult(
            req.rid, np.asarray(tokens, np.int32).reshape(-1),
            int(np.asarray(req.prompt).shape[-1]), req.n_new,
            req.arrival_s, admit_s, finish_s, first_token_s=first_s,
            status=status, deadline_s=self._eff_deadline(req))
        if self.telemetry is not None:
            self.telemetry.on_retire(res)
        (results if results is not None else self._pending).append(res)

    def _partial(self, st: _SlotState) -> np.ndarray:
        """A slot's tokens so far: tok0 + every collected segment."""
        return np.concatenate(
            [np.asarray([st.tok0], np.int32)] + st.collected)

    def _retire_slot(self, i: int) -> None:
        """Free slot ``i``: clearing the host ``active`` mirror freezes it
        from the next segment on (co-resident slots see no change), and a
        paged slot returns its pages."""
        self._slot[i] = None
        self._gens[i] = None
        self._active[i] = False
        if self.paged:
            self.pool.free_slot(i)

    def _kill_pf_member(self, pf: _PrefillGroup, i: int) -> None:
        """Take member ``i`` out of an in-flight chunked admission: its
        reserved slot and pages free now, its row keeps chunking but never
        activates, and the group's chunk count shrinks to its chunking
        members' longest prompt.  A prefix the group registered on a miss
        is unregistered when no member is left to fill its pages."""
        slot = pf.slots[i]
        if slot is not None:
            self._reserved.discard(slot)
            if self.paged and slot in self.pool.slot_pages:
                self.pool.free_slot(slot)
            pf.slots[i] = None
        pf.dead.add(i)
        alive = [j for j in range(len(pf.reqs)) if j not in pf.dead]
        if pf.reg_key is not None and not any(pf.slots[j] is not None
                                              for j in alive):
            self.pool.release(self.pool.prefixes.pop(pf.reg_key, ()))
            pf.reg_key = None
        if not alive:
            self._pf = None
        else:
            pf.n_chunks = max(-(-len(pf.reqs[j].prompt) // pf.chunk)
                              for j in alive)

    def _shed_victim(self, req: Request) -> Optional[Request]:
        """Overload: whom to shed when the queue holds ``queue_cap``
        requests.  "reject" sheds the arrival, "oldest" the longest
        queued, "lowest-priority" the lowest-priority queued request
        unless the arrival is lower still (ties shed the arrival).  The
        victim returned is off the queue already."""
        if self.shed_policy == "reject":
            return req
        if self.shed_policy == "oldest":
            return self.queue.popleft()
        victim = min(self.queue, key=lambda r: r.priority)
        if req.priority <= victim.priority:
            return req
        self.queue = deque(r for r in self.queue if r is not victim)
        return victim

    def _reap(self, clock, results: List[RequestResult]) -> None:
        """Retire deadline-expired work at a segment boundary: queued
        requests time out before admission (empty tokens), chunking
        members leave their group, resident slots freeze through the
        active mask and surface their partial tokens."""
        if self.deadline_s is None and not self._any_deadlines:
            return
        now = clock()

        def expired(r):
            d = self._eff_deadline(r)
            return d is not None and now - r.arrival_s > d

        if any(expired(r) for r in self.queue):
            keep: deque = deque()
            for r in self.queue:
                if expired(r):
                    self._emit(results, r, np.zeros((0,), np.int32),
                               now, now, "timeout")
                else:
                    keep.append(r)
            self.queue = keep
        pf = self._pf
        if pf is not None:
            for i, r in enumerate(pf.reqs):
                if i not in pf.dead and expired(r):
                    self._emit(results, r, np.zeros((0,), np.int32),
                               now, now, "timeout")
                    self._kill_pf_member(pf, i)
        for i, st in enumerate(self._slot):
            if st is not None and expired(st.req):
                self._emit(results, st.req, self._partial(st), st.admit_s,
                           now, "timeout", first_s=st.first_token_s)
                self._retire_slot(i)

    @property
    def _any_deadlines(self) -> bool:
        return (any(r.deadline_s is not None for r in self.queue)
                or (self._pf is not None
                    and any(r.deadline_s is not None
                            for r in self._pf.reqs))
                or any(s is not None and s.req.deadline_s is not None
                       for s in self._slot))

    def cancel(self, rid: int, now: float = 0.0) -> bool:
        """Cancel a request wherever it is: queued (empty tokens), in a
        chunked admission (the group shrinks, the other members are
        untouched) or resident (its tokens so far; slot and pages free as
        at a normal retirement, co-resident slots untouched).  False for
        an unknown or finished rid.  The result (status "cancelled")
        surfaces at the next admission point."""
        for r in self.queue:
            if r.rid == rid:
                self.queue = deque(x for x in self.queue if x is not r)
                self._emit(None, r, np.zeros((0,), np.int32), now, now,
                           "cancelled")
                return True
        pf = self._pf
        if pf is not None:
            for i, r in enumerate(pf.reqs):
                if r.rid == rid and i not in pf.dead:
                    self._emit(None, r, np.zeros((0,), np.int32), now, now,
                               "cancelled")
                    self._kill_pf_member(pf, i)
                    return True
        for i, st in enumerate(self._slot):
            if st is not None and st.req.rid == rid:
                self._emit(None, st.req, self._partial(st), st.admit_s,
                           now, "cancelled", first_s=st.first_token_s)
                self._retire_slot(i)
                return True
        return False

    def _scrub_all(self, clock, results: List[RequestResult]) -> None:
        """A segment raised: the resident cache, written in place, may
        hold a half-run segment, so every in-flight request fails
        (resident slots with their pre-segment tokens, chunking members
        empty), the graphs are dropped (they hold the old cache's
        addresses), the resident cache and page pool are rebuilt (the
        prefix registry lives in the pool's pages and goes with it) and
        the queue keeps being served; the next segment captures anew.
        Stats and queue are kept.  This recovers from faults that surface
        on the host as exceptions; a sticky device fault leaves the CUDA
        context unusable and needs a new process."""
        now = clock()
        for i, st in enumerate(self._slot):
            if st is None:
                continue
            self._emit(results, st.req, self._partial(st), st.admit_s,
                       now, "failed", first_s=st.first_token_s)
        pf = self._pf
        if pf is not None:
            for i, r in enumerate(pf.reqs):
                if i not in pf.dead:
                    self._emit(results, r, np.zeros((0,), np.int32),
                               now, now, "failed")
        self._init_resident()

    def health(self) -> Dict[str, object]:
        """Liveness and degradation snapshot for a serving front door:
        occupancy, watchdog timings, failure counters and the last error
        recorded."""
        pf = self._pf
        return {
            "resident": sum(s is not None for s in self._slot),
            "queued": len(self.queue),
            "reserved": len(self._reserved),
            "chunking": 0 if pf is None else len(pf.reqs) - len(pf.dead),
            "pool_free": self.pool.available() if self.paged else None,
            "segments": self.stats["segments"],
            "median_segment_s": self._watchdog.median_step_s,
            "slow_segments": len(self._watchdog.slow_steps),
            "watchdog_slow": self.stats["watchdog_slow"],
            "dispatch_failures": self.stats["dispatch_failures"],
            "proposer_failures": self.stats["proposer_failures"],
            "spec_degraded": self._spec_degraded,
            "failed": self.stats["failed"],
            "shed": self.stats["shed"],
            "cancelled": self.stats["cancelled"],
            "timeout": self.stats["timeout"],
            "last_error": self._last_error,
        }

    def weight_bytes_per_device(self) -> int:
        """The engine's resident weight bytes on this rank's device."""
        return self.engine.weight_bytes_per_device()

    # -- warmup / reset ------------------------------------------------------

    @torch.inference_mode()
    def _init_resident(self) -> None:
        """(Re)build the resident cache, the page pool (with its prefix
        registry, whose pages the cache holds) and every per-slot host
        mirror, dropping first the graphs captured on the old cache: the
        next segment captures anew.  Shared by ``reset`` and
        ``_scrub_all``."""
        if self.graphs is not None:
            self.graphs.clear()
        self._cur_mode: Optional[str] = None
        self.pool = (PagePool(self.pool_pages, self._page_rows)
                     if self.paged else None)
        self._caches = None               # free the old cache first
        self._caches = init_cache(
            self.engine.mcfg, self._hi - self._lo, self.max_len,
            self.engine.decode_flags, dtype=self.engine.cache_dtype,
            device=self.device,
            pages=self.pool_pages if self.paged else None)
        # this rank's slots' pending tokens
        self._tok = torch.zeros((self._hi - self._lo, 1), dtype=torch.long,
                                device=self.device)
        self._gens: List[Optional[torch.Generator]] = [None] * self.slots
        self._active = np.zeros((self.slots,), bool)
        self._greedy = np.ones((self.slots,), bool)
        self._temps = [1.0] * self.slots
        self._slot: List[Optional[_SlotState]] = [None] * self.slots
        self._reserved: Set[int] = set()
        self._pf: Optional[_PrefillGroup] = None
        self._probe_prev.clear()

    def reset(self) -> None:
        """Zero all slots, the queue and the stats, and rebuild the
        resident cache (``_init_resident``).  With telemetry, its metrics,
        events and spans restart too; its compile log is kept."""
        self.stats = {"segments": 0, "decode_steps": 0, "useful_tokens": 0,
                      "admitted": 0, "prefill_s": 0.0, "chunks": 0,
                      "chunk_s": 0.0, "stall_s": 0.0, "segment_s": 0.0,
                      "prefix_hits": 0, "prefix_tokens_reused": 0,
                      "spec_rounds": 0, "spec_emitted": 0, "draft_s": 0.0,
                      "accept_hist": [0] * (self.spec + 1),
                      "shed": 0, "cancelled": 0, "timeout": 0, "failed": 0,
                      "dispatch_failures": 0, "proposer_failures": 0,
                      "watchdog_slow": 0, "probe_steps": 0, "probe_s": 0.0}
        self._spec_degraded = False
        self._spec_fail_streak = 0
        self.last_proposer_error: Optional[str] = None
        self._last_error: Optional[str] = None
        self._watchdog = StepWatchdog()
        self._live: Set[int] = set()
        self._enq_s: Dict[int, float] = {}
        self._pending: List[RequestResult] = []
        self._unfundable: Dict[int, int] = {}
        self._init_resident()
        self.queue.clear()
        if self.telemetry is not None:
            self.telemetry.reset()

    def warmup(self, prompt_lens: Sequence[int]) -> None:
        """Run the admission and decode shapes of the prompt buckets
        covering ``prompt_lens`` once (at both admission widths, 1 and
        ``slots``), reset, and capture the decode step's graph on the new
        resident cache.  This takes first-call set-up (library handles,
        allocator growth, the capture) out of the first requests'
        latency.  Another dsa_mode's graph is captured on its first
        segment."""
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
                        self._step_decode(lambda: 0.0, sink)
                rid -= n
        self.reset()
        self._segment_step()
        if self.spec:
            self._spec_steps()

    def _segment_step(self, mode: Optional[str] = None):
        """The segment's masked decode step over the resident cache under
        ``mode`` (default the current segment mode, else the engine's):
        ``step(tok (B, 1), mask (B,)) -> logits (B, 1, V)``.  On the card
        a replay of that mode's CUDA graph (program "segment"), captured
        on its first call after a reset, perhaps with slots live (its
        warm-up steps have no active row, so they change nothing); on the
        CPU the step run eagerly."""
        e, caches = self.engine, self._caches
        flags = self._flags(mode or self._cur_mode or e.decode_flags.dsa_mode)

        def step(tok, mask):
            return decode_step(e.params, e.mcfg, flags, tok, caches,
                               active=mask)[0]

        if self.graphs is None:
            def eager(tok, mask):
                self._note("segment", tok, mask, caches, flags)
                return step(tok, mask)
            return eager
        return self.graphs.step(
            step_key(e.mcfg, flags, self._hi - self._lo, self.paged), step,
            caches, self._hi - self._lo, masked=True, program="segment")

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
        Every step also folds the finiteness of each active row's logits
        into ``fin`` on the device.  One host sync at the end collects the
        segment's tokens and ``fin``: a slot whose logits went non-finite
        fails with its pre-segment tokens, the others are untouched.

        Faults (with an injector): ``nan_logits`` NaNs the target slot's
        logits row after each step's forward (outside the graph, in this
        segment only), ``dispatch`` skips the segment with nothing run,
        ``slow_segment`` stalls inside the watchdog's window.  A segment
        that raises is scrubbed (``_scrub_all``)."""
        remaining = np.asarray(
            [s.remaining if s else 0 for s in self._slot], np.int32)
        mode = self._cur_mode or self.engine.decode_flags.dsa_mode
        poison = None
        inj = self.injector
        if inj is not None:
            inj.telemetry = self.telemetry
            for i, st in enumerate(self._slot):
                if st is not None and inj.take("nan_logits",
                                               st.req.rid) is not None:
                    if poison is None:
                        poison = np.zeros((self.slots,), bool)
                    poison[i] = True
            if inj.take("dispatch") is not None:
                # a transient dispatch failure: nothing runs, no state
                # changes, and the serving loop retries next iteration
                self.stats["dispatch_failures"] += 1
                return
        act = (self._active[None, :]
               & (remaining[None, :] > np.arange(self.seg_len)[:, None]))
        lo, hi = self._lo, self._hi       # this rank's slots
        sampled = [i for i in range(lo, hi)
                   if self._slot[i] is not None and not self._greedy[i]]
        t0 = time.monotonic()
        self._watchdog.start()
        if inj is not None:
            f = inj.take("slow_segment")
            if f is not None:
                time.sleep(f.delay_s)     # stall inside the watchdog window
        try:
            step = self._segment_step()
            act_dev = torch.as_tensor(act[:, lo:hi],
                                      device=self.device)  # one upload
            bad = (None if poison is None else torch.as_tensor(
                poison[lo:hi], device=self.device)[:, None])
            n_act = act.sum(axis=1)       # every rank runs the same steps
            tok = self._tok
            fin = torch.ones((hi - lo,), dtype=torch.bool,
                             device=self.device)
            outs = []
            steps = 0
            for t in range(self.seg_len):
                if n_act[t] == 0:         # no slot decodes: skip the step
                    outs.append(tok)
                    continue
                lg = step(tok, act_dev[t])[:, -1]
                if bad is not None:
                    lg = torch.where(bad, float("nan"), lg)
                fin &= ~act_dev[t] | torch.isfinite(lg).all(dim=-1)
                steps += 1
                nxt = lg.argmax(dim=-1, keepdim=True)
                for i in sampled:
                    if act[t, i]:
                        r = i - lo
                        nxt[r:r + 1] = _sample(lg[r:r + 1], self._gens[i],
                                               False, self._temps[i])
                tok = torch.where(act_dev[t][:, None], nxt, tok)
                outs.append(tok)
            # the segment's one sync: its tokens and each slot's fin, every
            # rank's slots (one all-gather over "data" under a mesh)
            host = self.engine.gather_rows(
                torch.cat(outs + [fin[:, None].long()], dim=1),
                self.slots).cpu()
        except Exception as e:            # a segment that raised: scrub
            self._last_error = repr(e)
            self.stats["dispatch_failures"] += 1
            if self.telemetry is not None:
                self.telemetry.on_error(repr(e))
            self._scrub_all(clock, results)
            return
        toks = host[:, :-1].numpy()
        fin = host[:, -1].numpy().astype(bool)
        self._tok = tok
        self._active = self._active & (remaining > self.seg_len)
        now = clock()
        self.stats["segments"] += 1
        self.stats["decode_steps"] += steps
        seg_wall = time.monotonic() - t0
        self.stats["segment_s"] += seg_wall
        slow = self._watchdog.stop(self.stats["segments"])
        if slow:
            self.stats["watchdog_slow"] += 1
        ut0 = self.stats["useful_tokens"]
        n_res = sum(s is not None for s in self._slot)
        for i, st in enumerate(self._slot):
            if st is None:
                continue
            if not fin[i]:
                # a non-finite logits row: this slot's tokens are garbage
                # from its first bad step on, so it fails with its
                # pre-segment tokens; no other row read its logits
                self._last_error = (f"request {st.req.rid}: non-finite "
                                    f"logits row in decode segment")
                self._emit(results, st.req, self._partial(st), st.admit_s,
                           now, "failed", first_s=st.first_token_s)
                self._retire_slot(i)
                continue
            emitted = min(st.remaining, self.seg_len)
            st.collected.append(toks[i, :emitted].astype(np.int32))
            st.extend_history(st.collected[-1])
            st.remaining -= emitted
            self.stats["useful_tokens"] += emitted
            if st.remaining == 0:
                self._emit(results, st.req, self._partial(st), st.admit_s,
                           now, "ok", first_s=st.first_token_s)
                self._retire_slot(i)
        tel = self.telemetry
        if tel is not None:
            tel.on_segment(
                "decode_segment", seg_wall, mode=mode, active=n_res,
                tokens=self.stats["useful_tokens"] - ut0,
                queued=len(self.queue),
                resident=sum(s is not None for s in self._slot),
                pool_free=(self.pool.available() if self.paged else None),
                slow=slow)
            if (tel.sample_every
                    and self.stats["segments"] % tel.sample_every == 0):
                self._sparsity_probe(mode)

    # -- dynamic-sparsity sampling ------------------------------------------

    @torch.inference_mode()
    def _sparsity_probe(self, mode: str) -> None:
        """Sample the DSA block selection of the resident state: one eager
        decode step (program "probe", outside every graph) with
        ``RunFlags.sel_probe`` set hands out each layer's (idx, ok, kv_len)
        (logical block indices on a paged cache), and every cache row the
        step wrote is put back as it was (``_probe_step``).  Records per
        slot the keep rate, the churn of layer 0's selected blocks against
        the previous sample of the same request, and the overlap between
        adjacent layers' selections.  On a hybrid arch (jamba) only the
        attention layers select; the step's writes to the recurrent
        layers' state are put back too.  Its kernel launches (K4 or K1,
        one an attention layer) are counted apart, in
        ``stats["probe_steps"]``."""
        tel = self.telemetry
        flags = self._flags(mode)
        if not probe_ok(self.cfg, flags):
            return                        # no block selection to sample
        if not self._active.any():
            return
        t0 = time.monotonic()
        mask = torch.as_tensor(self._active[self._lo:self._hi],
                               device=self.device)
        sel = self._probe_step(self._tok, mask, self._caches,
                               dataclasses.replace(flags, sel_probe=True))
        nl = len(sel)
        host = self.engine.gather_rows(
            torch.cat([torch.cat([i.long(), o.long()], dim=1)
                       for i, o, _ in sel] + [sel[0][2].long()[:, None]],
                      dim=1), self.slots).cpu().numpy()
        self.stats["probe_steps"] += 1
        self.stats["probe_s"] += time.monotonic() - t0
        kb = sel[0][0].shape[1]
        idxs = [host[:, 2 * kb * li:2 * kb * li + kb] for li in range(nl)]
        oks = [host[:, 2 * kb * li + kb:2 * kb * (li + 1)].astype(bool)
               for li in range(nl)]
        kvs = host[:, -1]
        bk = self.cfg.dsa.block_k
        samples = []
        for b in range(self.slots):
            st = self._slot[b]
            if st is None or not self._active[b]:
                continue
            n_valid = max(1, -(-int(kvs[b]) // bk))
            sets = [frozenset(idx[b][ok[b]].tolist())
                    for idx, ok in zip(idxs, oks)]
            keep = float(np.mean([min(1.0, len(x) / n_valid)
                                  for x in sets]))
            overlap = None
            if len(sets) > 1:
                js = [len(a & c) / max(len(a | c), 1)
                      for a, c in zip(sets, sets[1:])]
                overlap = float(np.mean(js))
            churn = None
            prev = self._probe_prev.get(b)
            if prev is not None and prev[0] == st.req.rid and sets[0]:
                u = len(sets[0] | prev[1])
                churn = 1.0 - len(sets[0] & prev[1]) / max(u, 1)
            self._probe_prev[b] = (st.req.rid, sets[0])
            samples.append((b, st.req.rid, keep, churn, overlap))
        tel.on_sparsity_sample(self.stats["segments"], samples)

    def _probe_step(self, tok, mask, caches, flags) -> List[tuple]:
        """The probe program: one decode step with ``flags.sel_probe``,
        returning each layer's (idx, ok, kv_len).  The step writes
        ``caches`` in place (each writing row's K/V/kt row and their
        scales at its position, its ktb block or page, and ``pos``; a
        recurrent layer's state), so those entries are saved first and
        put back after: the resident cache ends bitwise as it was, at
        the cost of a few rows a layer (cloning the cache would cost
        gigabytes at full width)."""
        self._note("probe", tok, mask, caches, flags)
        bk = self.cfg.dsa.block_k
        saved = [_save_step_rows(lc, bk) for lc in attn_caches(caches)]
        try:
            return decode_step(self.engine.params, self.engine.mcfg, flags,
                               tok, caches, active=mask)[2]
        finally:
            for lc, sv in zip(attn_caches(caches), saved):
                _restore_step_rows(lc, sv)

    # -- speculative segments ------------------------------------------------

    def _spec_steps(self):
        """The verify forward and commit of the current segment mode (the
        engine's when none) over the resident cache: graph replays on the
        card, captured on the first call after a reset, with all-false
        masks that change nothing; eager on the CPU."""
        flags = dataclasses.replace(
            self._flags(self._cur_mode or self.engine.decode_flags.dsa_mode),
            spec_verify=True)
        return self.engine.spec_steps(self._hi - self._lo, self.spec, flags,
                                      caches=self._caches)

    @torch.inference_mode()
    def run_spec_segment(self, clock, results: List[RequestResult]) -> None:
        """A speculative segment: up to ``spec_rounds`` draft-and-verify
        rounds over all slots.  Each round hands the proposer a read-only
        view of each slot's history, verifies and commits the drafts
        (``SpeculativeDecoder.round``: one host sync) and collects each
        slot's 1 to K + 1 tokens; a slot retires as soon as its budget is
        spent.  Stats count only executed rounds, and ``segment_s``
        leaves drafting out, so the chunk-burst tuner reads device-bound
        time.  A proposer that raises ends the segment; three failures in
        a row degrade the engine to plain segments, and a failure before
        any round runs a plain segment in its place (the injector's
        ``proposer`` point raises in its place)."""
        verify, commit = self._spec_steps()
        t0 = time.monotonic()
        self._watchdog.start()
        draft_s0 = self.stats["draft_s"]
        ut0 = self.stats["useful_tokens"]
        rounds_run = 0
        for _ in range(self.spec_rounds):
            if not any(st is not None for st in self._slot):
                break
            ctxs = [_ro_view(st.history, st.hist_len) if st is not None
                    else np.zeros((1,), np.int32) for st in self._slot]
            td = time.monotonic()
            try:
                if self.injector is not None:
                    self.injector.telemetry = self.telemetry
                    if self.injector.take("proposer") is not None:
                        raise FaultError("injected proposer fault")
                drafts = self.draft.propose(ctxs, self.spec)
            except Exception as e:      # a proposer costs speed, never work
                self.last_proposer_error = self._last_error = repr(e)
                self.stats["draft_s"] += time.monotonic() - td
                self.stats["proposer_failures"] += 1
                self._spec_fail_streak += 1
                if self._spec_fail_streak >= 3:
                    self._spec_degraded = True
                break
            self._spec_fail_streak = 0
            self.stats["draft_s"] += time.monotonic() - td
            remaining = np.asarray(
                [st.remaining if st else 0 for st in self._slot], np.int64)
            lo, hi = self._lo, self._hi   # this rank's slots
            self._tok, nxt, emit = self._spec.round(
                verify, commit, self._tok, drafts[lo:hi],
                self._active[lo:hi], remaining[lo:hi], self._greedy[lo:hi],
                self._temps[lo:hi], self._gens[lo:hi])
            nxt = self.engine.gather_rows(nxt, self.slots)
            emit = self.engine.gather_rows(emit, self.slots)
            now = clock()                 # the round has synced
            self.stats["spec_rounds"] += 1
            rounds_run += 1
            for i, st in enumerate(self._slot):
                if st is None or not emit[i]:
                    continue
                e = int(emit[i])
                st.collected.append(nxt[i, :e])
                st.extend_history(nxt[i, :e])
                st.remaining -= e
                self.stats["useful_tokens"] += e
                self.stats["spec_emitted"] += e
                self.stats["accept_hist"][e - 1] += 1
                if st.remaining == 0:
                    self._emit(results, st.req, self._partial(st),
                               st.admit_s, now, "ok",
                               first_s=st.first_token_s)
                    self._retire_slot(i)
        if rounds_run:
            self.stats["segments"] += 1
            seg_dev = ((time.monotonic() - t0)
                       - (self.stats["draft_s"] - draft_s0))
            self.stats["segment_s"] += seg_dev
            slow = self._watchdog.stop(self.stats["segments"])
            if slow:
                self.stats["watchdog_slow"] += 1
            if self.telemetry is not None:
                self.telemetry.on_segment(
                    "spec_segment", seg_dev,
                    mode=self._cur_mode or self.engine.decode_flags.dsa_mode,
                    active=sum(s is not None for s in self._slot),
                    tokens=self.stats["useful_tokens"] - ut0,
                    queued=len(self.queue),
                    resident=sum(s is not None for s in self._slot),
                    slow=slow, rounds=rounds_run)
        elif any(s is not None for s in self._slot):
            self.run_segment(clock, results)

    def _step_decode(self, clock, results: List[RequestResult]) -> None:
        """One decode segment in the current mode: speculative when the
        engine speculates, has not degraded, and the mode is inside the
        envelope (a per-request mode may not be); plain otherwise."""
        mode = self._cur_mode or self.engine.decode_flags.dsa_mode
        if (self.spec and not self._spec_degraded
                and can_speculate(self.cfg, mode, self.spec)):
            self.run_spec_segment(clock, results)
        else:
            self.run_segment(clock, results)

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
                self._step_decode(clock, results)
        results.extend(self._pending)     # e.g. everything shed up front
        self._pending.clear()
        return {r.rid: r.tokens for r in results}

    def serve(self, workload: Sequence[Request]) -> List[RequestResult]:
        """Open-loop wall-clock serving: requests become visible at their
        ``arrival_s`` offsets; admission starts between segments and
        chunked prompt ingestion interleaves with them."""
        items = sorted(workload, key=lambda r: r.arrival_s)
        results: List[RequestResult] = []
        i = 0
        t0 = time.monotonic()
        # every rank of a mesh reads rank 0's clock
        clock = lambda: self._agree(time.monotonic() - t0)
        while i < len(items) or self.has_work():
            now = clock()
            while i < len(items) and items[i].arrival_s <= now:
                self.submit(items[i])
                i += 1
            self.admit_ready(clock, results)
            self.step_prefill(clock, results)
            if any(s is not None for s in self._slot):
                self._step_decode(clock, results)
            elif self._pf is None and not self.queue and i < len(items):
                time.sleep(max(0.0, min(items[i].arrival_s - now, 0.05)))
            elif self._pf is None and self.queue and self._unfundable:
                # an anchor the pool cannot fund and nothing else to do:
                # bounded exponential backoff instead of a busy spin
                n = max(self._unfundable.values())
                time.sleep(min(0.001 * (1 << min(n, 6)), 0.05))
        results.extend(self._pending)
        self._pending.clear()
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
