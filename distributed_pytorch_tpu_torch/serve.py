"""Continuous batching: slot-based autoregressive serving, the port of the
JAX package's serve.py ContinuousBatcher.

A fixed pool of cache slots where sequences enter (bucketed batched prefill
into a free slot), decode in lockstep (one ragged decode step per token for
every slot) and retire independently (EOS or length budget), their slot
refilled from the queue at the next block boundary:

- the KV cache is either one contiguous (slots, Hkv, max_len, Dh) buffer
  per layer, or (``paged=True``) a shared pool of 512-token pages per layer
  that each slot owns through a block-table row, so cache memory scales
  with the pages allocated, not slots x max_len.  Page 0 is a RESERVED
  SCRATCH page: empty and released slots' table rows point at it, so their
  lockstep garbage writes never land in a page recycled to another slot;
- per-sequence exactness comes from the ragged decode step
  (generate.decode_step_ragged): every sequence reads exactly its own
  ``pos+1`` cache prefix (the decode kernel's per-sequence bound on the
  GPU; through the block table when paged) and writes its K/V at its own
  offset, clamped at its own allocated frontier (``_write_caps``);
- slot recycling needs no cache zeroing: the padded prompt rows a prefill
  writes beyond the prompt's true length, and a previous occupant's stale
  rows, are never read (reads stop at the occupant's own ``pos``), and each
  decode step overwrites its row before the bound reaches it;
- **multi-token scheduling** (``steps_per_sync``): one ``step()`` runs a
  decode block of up to ``steps_per_sync`` lockstep steps.  The JAX
  package runs the block as one device ``while_loop``; here it is a Python
  loop whose per-slot bookkeeping (token, position, budget, done flags,
  emitted tokens) stays on the device, with ONE host check per step for
  the early exit (every slot done).  The block's tokens come back to the
  host in one transfer at its end;
- **per-request sampling**: temperature / top_k / top_p / eos_id are
  ``submit()`` parameters, applied per slot by ``sample_per_seq``;
- **preemption** (paged): when live sequences outgrow an oversubscribed
  pool, the youngest occupant is host-swapped (its pages copied to host
  memory, the request parked on a resume queue) and swapped back into
  freshly allocated pages, bitwise, when the pool has room, instead of
  raising;
- **prefix caching** (``prefix_cache=True``, paged): full 512-token prompt
  pages are content-addressed by chain hash (``prefix_page_hashes``) and
  SHARED across requests through the block tables with refcounts; a
  repeated system prompt admits by pointing its table at the cached pages
  and prefilling only its suffix (one ``verify_step_ragged`` window).
  Sharing is read-only by construction (decode writes land at positions
  >= the prompt length, in the slot's own tail pages); unreferenced cached
  pages are reclaimed LRU under pool pressure before anything is
  preempted;
- **drained-tail compaction** (``compact_tail``, paged): with no queued or
  swapped work left and at most half the slots live, a block runs over a
  power-of-two number of rows holding only the live slots (their table
  rows carry the cache indirection).

Differences from the JAX batcher: ``inblock_refill`` and ``overlap``
default to False and passing True raises for now.  Both change only the
scheduling (when a retired slot refills, when a block's results are
fetched), never the tokens, so greedy outputs are the same.  Chunked
prefill (``prefill_chunk``) and in-batcher speculation (``speculate``,
``spec_ngram``) raise ``NotImplementedError`` naming ROADMAP.md slice 3b;
tensor parallelism (``mesh``, ``tp_axis``) and the fleet handoff
(``export_request``/``import_request``) name slice 5.
"""

from __future__ import annotations

import hashlib
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from . import generate as gen
from .models import transformer as tfm
from .models.transformer import not_ported
from .utils.device import resolve_device
from .utils.tracing import PhaseTimer

# submit() sentinel: "inherit the batcher default" -- distinct from None,
# which explicitly DISABLES eos for that request
_INHERIT = object()

SCHEDULING_SLICE = "ROADMAP.md queue 1, slice 3b (scheduling)"
FLEET_SLICE = "ROADMAP.md queue 1, slice 5 (fleet)"


def prefix_page_hashes(prompt, page: int) -> list[bytes]:
    """Chain hash per FULL ``page``-token prompt page: page i's key is the
    SHA-1 of page i-1's key followed by the int32 bytes of tokens
    [i*page, (i+1)*page), so it commits to every token before it and equal
    keys imply the cached page's K/V was computed under the identical
    context.  Byte for byte the JAX package's function (the fleet router
    walks these chains against each replica's registry, so the two must
    hash identically)."""
    prompt = np.asarray(prompt)
    out: list[bytes] = []
    h = b""
    for i in range(len(prompt) // page):
        h = hashlib.sha1(
            h + prompt[i * page:(i + 1) * page]
            .astype(np.int32).tobytes()).digest()
        out.append(h)
    return out


@dataclass
class _Request:
    rid: int
    prompt: np.ndarray            # (L,) int32
    max_new: int
    temperature: float = 1.0
    top_k: int = 0                # 0 = disabled
    top_p: float = 1.0            # >= 1 = disabled
    eos_id: int | None = None
    emitted: list = field(default_factory=list)
    done: bool = False
    # chain hashes of the prompt's full pages, computed once at submit when
    # prefix caching is on
    prefix_hashes: list | None = None
    t_submit: float = 0.0
    t_first: float | None = None  # first emission (TTFT = t_first - t_submit)
    t_done: float | None = None


@dataclass
class _Swapped:
    """A preempted request: its KV pages live on the HOST until the pool
    can take it back.  Host-swap rather than requeue-and-re-prefill because
    the generated prefix can outgrow every prompt bucket; restoring the
    pages bitwise keeps the request exactly where it was."""
    req: _Request
    kv: list                      # per cache leaf: (n_pages, Hkv, page, *)
    n_pages: int
    pos: int                      # last written position
    last_tok: int


class ContinuousBatcher:
    """Fixed-slot continuous batching over one model.

    Usage::

        cb = ContinuousBatcher(params, cfg, slots=4, max_len=512,
                               eos_id=0, temperature=0.8, top_k=50)
        rid = cb.submit(prompt_tokens, max_new=128)   # queue (any number)
        while cb.pending():
            for rid, tok in cb.step():               # tokens as they land
                ...
        out = cb.result(rid)                          # (L + emitted,) int32

    ``run(prompts, max_new)`` drives submit/step to completion.  The
    batcher runs on ``device`` (the GPU by default); ``params`` must live
    there.  ``paged=True`` serves from a page pool (``pool_pages`` pages of
    512 tokens, one of them the reserved scratch page; default enough for
    every slot at max_len), with preemption, ``prefix_cache`` and
    ``compact_tail`` as the module docstring describes.

    ``compact_tail`` determinism caveat (as in the JAX batcher): a
    compacted block is a narrower dispatch, so bf16 GREEDY streams can
    flip at near-ties at the compaction boundary (a different
    accumulation shape), and SAMPLED streams change there in any dtype
    (``sample_per_seq`` draws per row over the dispatch shape, so a
    request's draws shift when its row moves).  ``compact_tail=False``
    keeps every dispatch full-width when seeded reproducibility matters;
    f32 greedy is exact either way.
    """

    def __init__(self, params, cfg: tfm.TransformerConfig, *,
                 slots: int = 4, max_len: int = 1024,
                 temperature: float = 1.0, top_k: int | None = None,
                 top_p: float | None = None,
                 eos_id: int | None = None, dtype=None,
                 prompt_buckets: tuple[int, ...] = (32, 128, 512),
                 seed: int = 0, decode_kernel: bool | None = None,
                 steps_per_sync: int = 8,
                 prefill_chunk: int | None = None,
                 paged: bool = False, pool_pages: int | None = None,
                 inblock_refill: bool = False,
                 schedule: str = "fifo",
                 compact_tail: bool = True,
                 speculate: int = 0, spec_ngram: int = 2,
                 prefix_cache: bool = False,
                 overlap: bool = False,
                 kv_dtype=None,
                 mesh=None, tp_axis: str = "model",
                 device: str | torch.device = "cuda"):
        if prefix_cache:
            if not paged:
                raise ValueError("prefix_cache requires paged=True (the "
                                 "sharing rides the block tables)")
            if prefill_chunk is not None:
                raise ValueError(
                    "prefix_cache does not compose with prefill_chunk: "
                    "chunked admission re-prefills every prompt and "
                    "would silently never share pages")
        refused = {"speculate > 0": speculate > 0,
                   "prefill_chunk": prefill_chunk is not None,
                   "inblock_refill=True": inblock_refill,
                   "overlap=True": overlap,
                   "spec_ngram != 2": spec_ngram != 2}
        for what, on in refused.items():
            if on:
                raise not_ported(what, SCHEDULING_SLICE)
        if mesh is not None or tp_axis != "model":
            raise not_ported("mesh / tp_axis (tensor-parallel serving)",
                             gen.PARALLEL_SLICE)
        tfm._refuse_moe(cfg)
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.kv_dtype = gen.canon_kv_dtype(kv_dtype)
        self.max_len = gen.pad_cache_len(max_len)
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.eos_id = eos_id
        self.dtype = dtype
        self.buckets = tuple(sorted(b for b in prompt_buckets
                                    if b <= self.max_len))
        if not self.buckets:
            raise ValueError(f"no prompt bucket fits max_len {max_len}")
        self.use_kernel = gen.default_decode_kernel(decode_kernel,
                                                    self.device)
        if steps_per_sync < 1:
            raise ValueError(f"steps_per_sync must be >= 1, got "
                             f"{steps_per_sync}")
        self.steps_per_sync = steps_per_sync
        if schedule not in ("fifo", "longest_first"):
            raise ValueError(f"unknown schedule {schedule!r}: expected "
                             f"'fifo' or 'longest_first'")
        self.schedule = schedule
        self._queue_dirty = False
        self.kv_heads = params["layers.0.wk"].shape[1]
        kv_kw = dict(dtype=dtype or torch.float32, kv_heads=self.kv_heads,
                     kv_dtype=self.kv_dtype, device=self.device)
        self.paged = paged
        self.page = 512
        self.pages_per_slot = self.max_len // self.page
        if paged:
            if not self.use_kernel and decode_kernel is not None:
                raise ValueError("paged serving requires the decode-kernel "
                                 "path (the page table lives in its "
                                 "lookup); drop decode_kernel=False")
            self.use_kernel = True  # the plain version on CPU tensors
            self.pool_pages = (pool_pages if pool_pages is not None
                               else slots * self.pages_per_slot + 1)
            if self.pool_pages - 1 < self.pages_per_slot:
                raise ValueError(
                    f"pool_pages {self.pool_pages} cannot hold even one "
                    f"max_len sequence ({self.pages_per_slot} pages + the "
                    f"reserved scratch page)")
            self.cache = gen.init_paged_cache(cfg, self.pool_pages,
                                              self.page, **kv_kw)
            self.table = np.zeros((slots, self.pages_per_slot), np.int32)
            self.free_pages = deque(range(1, self.pool_pages))
            self.slot_pages: list[list[int]] = [[] for _ in range(slots)]
            # preemption: victims host-swap their pages and wait here;
            # admission sequence numbers pick the YOUNGEST victim
            self.swapped: deque[_Swapped] = deque()
            self.slot_admit_seq = np.zeros(slots, np.int64)
            self._admit_counter = 0
        else:
            self.cache = gen.init_cache(cfg, slots, self.max_len, **kv_kw)
        self.compact_tail = compact_tail
        self.prefix_cache = prefix_cache
        if prefix_cache:
            self.registry: dict[bytes, int] = {}   # chain hash -> page id
            self.page_hash: dict[int, bytes] = {}  # registered page -> hash
            self.page_refs: dict[int, int] = {}    # registered page -> refs
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        # host-side slot state
        self.pos = np.zeros(slots, np.int32)        # last written position
        self.occupant: list[_Request | None] = [None] * slots
        self.last_tok = np.zeros(slots, np.int32)   # next input token
        self.slot_temp = np.ones(slots, np.float32)
        self.slot_topk = np.zeros(slots, np.int32)
        self.slot_topp = np.ones(slots, np.float32)
        self.slot_eos = np.full(slots, -1, np.int32)  # -1 = no eos
        self.queue: deque[_Request] = deque()
        self.requests: dict[int, _Request] = {}
        self._next_rid = 0
        # per-phase wall clock: host_plan / prefill / dispatch / fetch /
        # host_parse (timing_stats)
        self.timers = PhaseTimer()
        # accounting: slot-steps dispatched vs tokens delivered, and the
        # page pool's preemption, compaction and prefix-cache events
        self.stats = {"decode_dispatches": 0, "decode_steps": 0,
                      "slot_steps": 0, "emitted_tokens": 0,
                      "wasted_slot_steps": 0, "prefill_dispatches": 0,
                      "batch_admissions": 0, "evictions": 0, "swap_ins": 0,
                      "compact_dispatches": 0, "prefix_hits": 0,
                      "prefix_pages_shared": 0, "prefix_reclaimed": 0}

    # -- submission / results --------------------------------------------
    def submit(self, prompt, max_new: int = 128, *,
               temperature: float | None = None,
               top_k: int | None = None,
               top_p: float | None = None,
               eos_id=_INHERIT) -> int:
        """Queue a request.  Sampling parameters default to the batcher's;
        ``eos_id=None`` explicitly disables eos for this request even when
        the batcher has a default (omit the argument to inherit)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if len(prompt) > self.buckets[-1]:
            raise ValueError(
                f"prompt of {len(prompt)} tokens exceeds the largest "
                f"bucket {self.buckets[-1]}")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if len(prompt) + max_new > self.max_len:
            raise ValueError(
                f"prompt {len(prompt)} + max_new {max_new} exceeds "
                f"max_len {self.max_len}")
        rid = self._next_rid
        self._next_rid += 1
        top_k = self.top_k if top_k is None else top_k
        top_p = self.top_p if top_p is None else top_p
        req = _Request(
            rid, prompt, max_new,
            temperature=(self.temperature if temperature is None
                         else temperature),
            top_k=0 if top_k is None else top_k,
            top_p=1.0 if top_p is None else top_p,
            eos_id=self.eos_id if eos_id is _INHERIT else eos_id)
        req.t_submit = time.perf_counter()
        if self.prefix_cache:
            req.prefix_hashes = prefix_page_hashes(req.prompt, self.page)
        self.requests[rid] = req
        self.queue.append(req)
        self._queue_dirty = True
        return rid

    def pending(self) -> bool:
        return (bool(self.queue) or (self.paged and bool(self.swapped))
                or any(o is not None for o in self.occupant))

    def queue_depth(self) -> int:
        """Requests accepted but not yet generating."""
        return len(self.queue)

    def timing_stats(self) -> dict:
        """Per-phase wall-clock summary over every ``step()`` so far:
        ``host_plan`` (admission, swap-in, page planning and staging),
        ``prefill`` (admission prefills), ``dispatch`` (the decode block's
        steps, including the per-step early-exit check), ``fetch`` (the
        block's device->host transfer), ``host_parse`` (emission
        bookkeeping)."""
        return self.timers.summary()

    def result(self, rid: int) -> np.ndarray:
        req = self.requests[rid]
        return np.concatenate([req.prompt,
                               np.asarray(req.emitted, np.int32)])

    def latency_stats(self) -> dict[str, float]:
        """Per-request latency percentiles over COMPLETED requests, in
        seconds of host clock (``ttft_*``: submit -> first emission;
        ``total_*``: submit -> retirement).  With none completed, returns
        ``{"completed": 0}`` only."""
        done = [r for r in self.requests.values()
                if r.done and r.t_done is not None]
        if not done:
            return {"completed": 0}
        ttft = np.asarray([r.t_first - r.t_submit for r in done])
        total = np.asarray([r.t_done - r.t_submit for r in done])
        return {"completed": len(done),
                "ttft_p50": float(np.percentile(ttft, 50)),
                "ttft_p95": float(np.percentile(ttft, 95)),
                "total_p50": float(np.percentile(total, 50)),
                "total_p95": float(np.percentile(total, 95))}

    def utilization(self) -> float:
        """Dispatched slot-step utilization: sampled emissions from decode
        blocks / dispatched slot-steps (each admission's first token comes
        from its prefill, not a slot-step).  0.0 before the first block."""
        s = self.stats
        if s["slot_steps"] == 0:
            return 0.0
        return (s["emitted_tokens"] - s["batch_admissions"]) / s["slot_steps"]

    def export_request(self, rid: int):
        raise not_ported("export_request (fleet KV handoff)", FLEET_SLICE)

    def import_request(self, state: dict):
        raise not_ported("import_request (fleet KV handoff)", FLEET_SLICE)

    # -- the page pool (paged) ---------------------------------------------
    def _avail_pages(self) -> int:
        """Pages the pool can still supply: the free list plus registry
        pages no occupant references (reclaimable prefix cache)."""
        n = len(self.free_pages)
        if self.prefix_cache:
            n += sum(1 for pid in self.registry.values()
                     if self.page_refs.get(pid, 0) == 0)
        return n

    def _reclaim_registry(self, n: int) -> None:
        """Free ``n`` unreferenced registry pages, least recently used first
        (insertion order, ``_admit_shared`` re-inserting on every hit)."""
        for h in list(self.registry):
            if n <= 0:
                break
            pid = self.registry[h]
            if self.page_refs.get(pid, 0) == 0:
                del self.registry[h]
                del self.page_hash[pid]
                del self.page_refs[pid]
                self.free_pages.append(pid)
                self.stats["prefix_reclaimed"] += 1
                n -= 1

    def _take_free_page(self) -> int:
        if not self.free_pages and self.prefix_cache:
            self._reclaim_registry(1)
        if not self.free_pages:
            raise RuntimeError(
                f"KV page pool exhausted ({self.pool_pages} pages): "
                f"raise pool_pages or lower concurrency/max_new")
        return self.free_pages.popleft()

    def _alloc_pages(self, slot: int, upto_pos: int) -> None:
        """Ensure ``slot``'s block table covers positions [0, upto_pos]."""
        need = min(upto_pos // self.page + 1, self.pages_per_slot)
        pages = self.slot_pages[slot]
        while len(pages) < need:
            pid = self._take_free_page()
            self.table[slot, len(pages)] = pid
            pages.append(pid)

    def _release_pages(self, slot: int) -> None:
        """Return a retired slot's pages and repoint its table row at the
        scratch page 0 (resetting pos too): the slot keeps lockstep-writing
        in later dispatches until re-admitted, and those writes must never
        land in pages recycled to OTHER slots.  Registered (prefix-cache)
        pages stay in the registry at one fewer reference."""
        for pid in self.slot_pages[slot]:
            if self.prefix_cache and pid in self.page_hash:
                self.page_refs[pid] -= 1
            else:
                self.free_pages.append(pid)
        self.slot_pages[slot] = []
        self.table[slot, :] = 0
        self.pos[slot] = 0

    def _write_caps(self) -> np.ndarray:
        """Per-slot last writable position: the allocated frontier under
        paging (a slot that keeps lockstep-writing after it is done must
        not dereference table entries it does not own), max_len-1 for the
        dense cache."""
        if not self.paged:
            return np.full(self.slots, self.max_len - 1, np.int32)
        return np.asarray([max(len(p) * self.page - 1, 0)
                           for p in self.slot_pages], np.int32)

    def _block_writes(self, rem: int) -> int:
        """Worst-case cache writes ONE block can make for a slot with
        ``rem`` emission budget: K lockstep steps, but no more than the
        budget (the early exit never writes past it; the lockstep writes of
        a done slot clamp at its frontier).  Every occupant is fully
        prefilled here; the JAX batcher also counts the prompt tokens an
        in-block admission has left (slice 3b)."""
        return min(self.steps_per_sync, rem)

    def _pages_short(self, upto_pos: int, owned: int = 0) -> int:
        """How many pages the pool must supply to cover positions
        [0, upto_pos] given ``owned`` pages already held."""
        return min(upto_pos // self.page + 1, self.pages_per_slot) - owned

    # -- prefix cache (prefix_cache=True) ----------------------------------
    def _prefix_lookup(self, req: _Request) -> list[int]:
        """Longest cached chain of the request's full prompt pages, capped
        so at least one suffix token is always left to prefill (its logits
        seed the first emission; shared pages are never re-written)."""
        hashes = req.prefix_hashes
        if len(req.prompt) % self.page == 0:
            hashes = hashes[:-1]
        return self._registry_chain(hashes)

    def _registry_chain(self, hashes: list[bytes]) -> list[int]:
        """Pages of the longest chain prefix present in the registry."""
        shared: list[int] = []
        for h in hashes:
            pid = self.registry.get(h)
            if pid is None:
                break
            shared.append(pid)
        return shared

    def _register_prompt_pages(self, slot: int, req: _Request) -> None:
        """Publish a freshly prefilled prompt's full pages.  Only pages
        wholly covered by prompt tokens register: the partial tail page
        takes decode writes and stays private."""
        for i, h in enumerate(req.prefix_hashes):
            pid = self.slot_pages[slot][i]
            if h in self.registry or pid in self.page_hash:
                continue  # this chain (or page) is already published
            self.registry[h] = pid
            self.page_hash[pid] = h
            self.page_refs[pid] = 1

    def _admit_shared(self, slot: int, req: _Request,
                      shared: list[int]) -> torch.Tensor:
        """Admit over cached prompt pages: the slot's table points at the
        shared pages (refcounted, LRU-touched), fresh tail pages are
        allocated, and only the uncached suffix prefills.  Returns the
        last-prompt-position logits."""
        self.stats["prefix_hits"] += 1
        self.stats["prefix_pages_shared"] += len(shared)
        pages = self.slot_pages[slot]
        for i, pid in enumerate(shared):
            self.page_refs[pid] += 1
            h = self.page_hash[pid]
            self.registry.pop(h)        # LRU touch: re-insert newest
            self.registry[h] = pid
            self.table[slot, i] = pid
            pages.append(pid)
        L = len(req.prompt)
        base = len(shared) * self.page
        # allocate through position L (decode's first write, needed next
        # block anyway); the suffix's pad writes clamp onto row L
        wcap = min(L, self.max_len - 1)
        self._alloc_pages(slot, wcap)
        last_logits = self._suffix_prefill(slot, req.prompt[base:], base,
                                           wcap)
        self.stats["prefill_dispatches"] += 1
        # publish freshly prefilled full pages BEYOND the shared chain
        self._register_prompt_pages(slot, req)
        return last_logits

    def _suffix_prefill(self, slot: int, suffix: np.ndarray, base: int,
                        wcap: int) -> torch.Tensor:
        """One bucketed (1, sbucket) window at positions base.. attends the
        shared pages through the slot's table (gen.verify_step_ragged) and
        writes its own K/V into the fresh tail pages; returns the (vocab,)
        logits at the true last prompt position.  Pad tokens past the
        suffix all clamp onto position ``wcap`` = the prompt length, the
        row decode writes first (overwritten before any read)."""
        dev = self.device
        n = len(suffix)
        sbucket = next(b for b in self.buckets if b >= n)
        chunk = torch.zeros((1, sbucket), dtype=torch.long, device=dev)
        chunk[0, :n] = torch.from_numpy(suffix.astype(np.int64))
        pos = base + torch.arange(sbucket, device=dev)[None]
        trow = torch.from_numpy(self.table[slot:slot + 1]).to(dev)
        logits, _ = gen.verify_step_ragged(
            self.params, self.cache, chunk, pos, torch.clamp(pos, max=wcap),
            cfg=self.cfg, dtype=self.dtype, page_table=trow)
        return logits[0, n - 1]

    # -- preemption: host-swap under pool pressure -------------------------
    def _leaves(self) -> list[torch.Tensor]:
        """Every cache leaf (K, V and, under int8, the scale pools), in one
        fixed order."""
        return [t for layer in self.cache.values() for t in layer.values()]

    def _evict(self, victim: int) -> None:
        """Preempt ``victim``: its pages are copied to host memory (every
        leaf, scales included, exactly the pages it owns) and the request
        joins the resume queue; the pages go back to the pool."""
        occ = self.occupant[victim]
        pids = torch.tensor(self.slot_pages[victim], device=self.device)
        kv = [leaf[pids].cpu() for leaf in self._leaves()]
        self.swapped.append(_Swapped(
            req=occ, kv=kv, n_pages=len(self.slot_pages[victim]),
            pos=int(self.pos[victim]), last_tok=int(self.last_tok[victim])))
        self.occupant[victim] = None
        self._release_pages(victim)
        self.stats["evictions"] += 1

    def _ensure_pages_or_evict(self, slot: int, upto: int) -> None:
        """Cover ``slot``'s write frontier, evicting the youngest occupant
        (possibly ``slot`` itself) while the pool is short.  Progress is
        guaranteed: one sequence always fits the pool (checked at init)."""
        while True:
            need = self._pages_short(upto, len(self.slot_pages[slot]))
            if need <= self._avail_pages():
                self._alloc_pages(slot, upto)
                return
            cands = [t for t in range(self.slots)
                     if self.occupant[t] is not None]
            victim = max(cands, key=lambda t: self.slot_admit_seq[t])
            self._evict(victim)
            if victim == slot:
                return  # the requester itself was youngest: it waits

    def _resume_swapped(self) -> None:
        """Swap preempted requests back into free slots, oldest first, when
        the pool can hold their pages plus the next block's writes (the
        headroom keeps them from being evicted again at once)."""
        for slot in range(self.slots):
            if not self.swapped:
                break
            if self.occupant[slot] is not None:
                continue
            sw = self.swapped[0]
            rem = sw.req.max_new - len(sw.req.emitted)
            upto = min(sw.pos + self._block_writes(rem),
                       self.max_len - 1)
            if self._avail_pages() < max(self._pages_short(upto),
                                         sw.n_pages):
                break
            self.swapped.popleft()
            self._alloc_pages(slot, sw.n_pages * self.page - 1)
            pids = torch.from_numpy(
                self.table[slot, :sw.n_pages].astype(np.int64)).to(
                    self.device)
            for leaf, host in zip(self._leaves(), sw.kv):
                leaf[pids] = host.to(self.device)
            self.occupant[slot] = sw.req
            self._set_slot_params(slot, sw.req)
            self.pos[slot] = sw.pos
            self.last_tok[slot] = sw.last_tok
            self._alloc_pages(slot, upto)
            self.stats["swap_ins"] += 1

    def _hold_for_resume(self) -> bool:
        """True while a preempted request waits on the resume queue: new
        admissions hold so freed pages accumulate for the oldest victim's
        swap-in instead of being taken by younger arrivals."""
        return self.paged and bool(self.swapped)

    # -- admission --------------------------------------------------------
    def _prefill(self, prompt: np.ndarray):
        """Bucketed prefill of one prompt into a (1, Hkv, bucket, Dh)
        scratch cache: returns ((vocab,) logits at the last valid position,
        the scratch cache)."""
        L = len(prompt)
        bucket = next(b for b in self.buckets if b >= L)
        padded = torch.zeros((1, bucket), dtype=torch.long,
                             device=self.device)
        padded[0, :L] = torch.from_numpy(prompt.astype(np.int64))
        slab = gen.init_cache(self.cfg, 1, bucket,
                              dtype=self.dtype or torch.float32,
                              kv_heads=self.kv_heads, kv_dtype=self.kv_dtype,
                              device=self.device)
        logits, slab = gen._forward_cached(
            self.params, slab, padded,
            torch.arange(bucket, device=self.device), 0, cfg=self.cfg,
            dtype=self.dtype, k_len=bucket, unembed_at=L - 1)
        return logits[0, 0], slab

    def _insert(self, slab, slot: int) -> None:
        """Write a prefill's (1, Hkv, bucket, Dh) slabs into the pool slot,
        in place."""
        for name, layer in self.cache.items():
            for leaf, big in layer.items():
                small = slab[name][leaf]
                big[slot, :, :small.shape[2]] = small[0]

    def _insert_paged(self, slab, slot: int) -> None:
        """Write a prefill's (1, Hkv, bucket, Dh) slabs into this slot's
        OWNED pages, page by page.  Allocation is by prompt length, so a
        padded bucket wider than the owned pages writes only the chunks
        the slot owns: the padded tail is never read (pos bound)."""
        bucket = next(iter(slab.values()))["k"].shape[2]
        n = min(-(-bucket // self.page), len(self.slot_pages[slot]))
        pids = [int(p) for p in self.table[slot, :n]]
        for name, layer in self.cache.items():
            for leaf, big in layer.items():
                small = slab[name][leaf][0]
                for c, pid in enumerate(pids):
                    rows = small[:, c * self.page:(c + 1) * self.page]
                    big[pid, :, :rows.shape[1]] = rows

    def _sample_first(self, req: _Request, last_logits) -> int:
        """Sample a freshly-admitted request's first token with ITS
        sampling parameters."""
        dev = self.device
        return int(gen.sample_per_seq(
            self.generator, last_logits[None],
            torch.full((1,), req.temperature, device=dev),
            torch.full((1,), req.top_k, dtype=torch.int32, device=dev),
            torch.full((1,), req.top_p, device=dev))[0])

    def _set_slot_params(self, slot: int, req: _Request) -> None:
        self.slot_temp[slot] = req.temperature
        self.slot_topk[slot] = req.top_k
        self.slot_topp[slot] = req.top_p
        self.slot_eos[slot] = -1 if req.eos_id is None else req.eos_id
        if self.paged:
            # admission order; preemption evicts the youngest occupant
            self._admit_counter += 1
            self.slot_admit_seq[slot] = self._admit_counter

    def _occupy(self, slot: int, req: _Request, first_tok: int,
                out: list) -> None:
        """Install a prefilled request into its slot and emit token 0."""
        self.occupant[slot] = req
        self.pos[slot] = len(req.prompt) - 1
        self._set_slot_params(slot, req)
        self.stats["batch_admissions"] += 1
        self._emit(slot, first_tok, out)

    def _fill_free_slots(self) -> list[tuple[int, int]]:
        """Prefill queued requests into free slots, one bucketed prefill
        each (a suffix prefill over cached pages under prefix caching);
        returns the (rid, first token) pairs.  When the page pool cannot
        hold the prompt, or a preempted request waits to resume, the queue
        WAITS instead of raising."""
        if self._hold_for_resume():
            return []
        out: list[tuple[int, int]] = []
        for slot in range(self.slots):
            if self.occupant[slot] is not None or not self.queue:
                continue
            head = self.queue[0]
            L = len(head.prompt)
            shared = self._prefix_lookup(head) if self.prefix_cache else []
            if self.paged:
                # shared admissions allocate through position L (the
                # suffix pad's clamp row, = decode's first write); idle
                # shared pages must not count as reclaimable (that would
                # destroy the very prefix about to be reused)
                upto = min(L, self.max_len - 1) if shared else L - 1
                shared_idle = sum(1 for pid in shared
                                  if self.page_refs.get(pid, 0) == 0)
                if (self._avail_pages() - shared_idle
                        < self._pages_short(upto) - len(shared)):
                    break  # pool full: hold admissions until pages free
            req = self.queue.popleft()
            if shared:
                last_logits = self._admit_shared(slot, req, shared)
            else:
                last_logits, slab = self._prefill(req.prompt)
                self.stats["prefill_dispatches"] += 1
                if self.paged:
                    self._alloc_pages(slot, L - 1)
                    self._insert_paged(slab, slot)
                    if self.prefix_cache:
                        self._register_prompt_pages(slot, req)
                else:
                    self._insert(slab, slot)
            self._occupy(slot, req, self._sample_first(req, last_logits),
                         out)
        return out

    def _emit(self, slot: int, tok: int, out: list) -> None:
        req = self.occupant[slot]
        if req.t_first is None:
            req.t_first = time.perf_counter()
        req.emitted.append(tok)
        out.append((req.rid, tok))
        self.stats["emitted_tokens"] += 1
        if ((req.eos_id is not None and tok == req.eos_id)
                or len(req.emitted) >= req.max_new):
            req.done = True
            req.t_done = time.perf_counter()
            self.occupant[slot] = None  # slot free; stale K/V never read
            if self.paged:
                self._release_pages(slot)
        else:
            self.last_tok[slot] = tok

    # -- the decode block -------------------------------------------------
    def _decode_block(self, st: dict[str, np.ndarray]):
        """Run up to ``steps_per_sync`` lockstep ragged decode steps over
        the dispatch's rows, staged in ``st`` (per row: input token, write
        position, budget, sampling parameters, write cap and, paged, the
        block-table row).  Per-row state stays on the device; the loop
        checks once per step whether every row is done.  A done row keeps
        computing in lockstep with its writes clamped at its cap.  Returns
        device tensors (tokens (K, w), emit mask (K, w), last written
        position per row) and the number of steps executed."""
        dev, k_steps = self.device, self.steps_per_sync

        def up(key, dtype=None):
            a = st[key] if dtype is None else st[key].astype(dtype)
            return torch.from_numpy(a).to(dev)

        tok, pos_d, rem = up("tok", np.int64), up("pos"), up("rem")
        temp, topk, topp, eos = up("temp"), up("topk"), up("topp"), up("eos")
        cap = up("cap")
        table = up("table") if self.paged else None
        n = len(st["pos"])
        done = rem <= 0  # empty and pad rows enter done
        lw = pos_d.clone()
        buf = torch.zeros((k_steps, n), dtype=torch.int32, device=dev)
        mask = torch.zeros((k_steps, n), dtype=torch.bool, device=dev)
        steps = 0
        while steps < k_steps and not bool(done.all()):
            logits, _ = gen.decode_step_ragged(
                self.params, self.cache, tok, pos_d, cfg=self.cfg,
                dtype=self.dtype, use_decode_kernel=self.use_kernel,
                page_table=table)
            toks = gen.sample_per_seq(self.generator, logits, temp, topk,
                                      topp)
            emit = ~done
            buf[steps] = toks
            mask[steps] = emit
            rem = rem - emit.to(rem.dtype)
            fin = emit & (((toks == eos) & (eos >= 0)) | (rem <= 0))
            lw = torch.where(emit, pos_d, lw)
            done = done | fin
            pos_d = torch.minimum(pos_d + 1, cap)
            tok = toks.long()
            steps += 1
        return buf, mask, lw, steps

    def _stage(self, live: list[int], budget: np.ndarray,
               pos: np.ndarray):
        """Per-row staging of one decode block: (st, cols, w).  Full width
        by default; with drained-tail compaction (paged, nothing queued or
        swapped, at most half the slots live) a power-of-two number of rows
        holding only the live slots, the pad rows dead (budget 0, cap 0,
        pos 0, table row 0: done at step 0, their clamped writes on the
        scratch page)."""
        st = {"tok": self.last_tok, "pos": pos, "rem": budget,
              "temp": self.slot_temp, "topk": self.slot_topk,
              "topp": self.slot_topp, "eos": self.slot_eos,
              "cap": self._write_caps()}
        if self.paged:
            st["table"] = self.table
        compact = (self.compact_tail and self.paged and not self.queue
                   and not self.swapped and len(live) <= self.slots // 2)
        if not compact:
            return ({k: np.array(a) for k, a in st.items()},
                    {s: s for s in live}, self.slots)
        w = 1 << max(len(live) - 1, 0).bit_length()
        sel = np.asarray(live + [live[0]] * (w - len(live)))
        st = {k: np.asarray(a)[sel] for k, a in st.items()}
        for key in ("rem", "cap", "pos", "table"):
            st[key][len(live):] = 0
        self.stats["compact_dispatches"] += 1
        return st, {s: j for j, s in enumerate(live)}, w

    def step(self) -> list[tuple[int, int]]:
        """Swap preempted requests back in, admit queued work into free
        slots (batched prefill), pre-allocate every live slot's pages for
        the block's worst-case writes (evicting the youngest occupant when
        the pool is short), then run one decode block.  Returns the (rid,
        token) pairs emitted this call, in per-slot sampling order."""
        out: list[tuple[int, int]] = []
        t_plan = time.perf_counter()
        if (self.schedule == "longest_first" and self._queue_dirty
                and len(self.queue) > 1):
            self.queue = deque(sorted(self.queue, key=lambda r: -r.max_new))
        self._queue_dirty = False
        if self.paged and self.swapped:
            self._resume_swapped()  # preempted requests take priority
        self.timers.add("host_plan", time.perf_counter() - t_plan)
        with self.timers.phase("prefill"):
            out += self._fill_free_slots()
        t_plan = time.perf_counter()
        live = [s for s in range(self.slots) if self.occupant[s] is not None]
        budget = np.zeros(self.slots, np.int32)
        pos = self.pos.copy()
        for s in live:
            occ = self.occupant[s]
            budget[s] = occ.max_new - len(occ.emitted)
            pos[s] = min(pos[s] + 1, self.max_len - 1)  # next write
        if self.paged:
            # pages covering this block's write frontier, pos + min(K,
            # budget) - 1: a slot that finishes early clamps at its
            # frontier, so the block never needs pages past its real writes
            for s in live:
                if self.occupant[s] is None:
                    continue  # evicted as an earlier slot's victim
                upto = min(int(pos[s]) + self._block_writes(int(budget[s]))
                           - 1, self.max_len - 1)
                self._ensure_pages_or_evict(s, upto)
            live = [s for s in live if self.occupant[s] is not None]
            budget[[s for s in range(self.slots)
                    if self.occupant[s] is None]] = 0
        if not live:
            self.timers.add("host_plan", time.perf_counter() - t_plan)
            return out
        st, cols, w = self._stage(live, budget, pos)
        self.timers.add("host_plan", time.perf_counter() - t_plan)
        with self.timers.phase("dispatch"):
            buf, mask, lw, steps = self._decode_block(st)
        with self.timers.phase("fetch"):
            # one device->host transfer for the whole block
            host = torch.cat([buf.reshape(-1),
                              mask.to(torch.int32).reshape(-1),
                              lw]).cpu().numpy()
        kn = self.steps_per_sync * w
        toks = host[:kn].reshape(self.steps_per_sync, w)
        mask = host[kn:2 * kn].reshape(self.steps_per_sync, w).astype(bool)
        lw = host[2 * kn:]
        with self.timers.phase("host_parse"):
            emitted_before = self.stats["emitted_tokens"]
            for s in live:
                j = cols[s]
                for i in range(steps):
                    if mask[i, j] and self.occupant[s] is not None:
                        self._emit(s, int(toks[i, j]), out)
                if self.occupant[s] is not None:
                    self.pos[s] = int(lw[j])
            self.stats["decode_dispatches"] += 1
            self.stats["decode_steps"] += steps
            self.stats["slot_steps"] += steps * w
            self.stats["wasted_slot_steps"] += (
                steps * w - (self.stats["emitted_tokens"] - emitted_before))
        return out

    def run(self, prompts, max_new: int = 128) -> dict[int, np.ndarray]:
        """Submit every prompt, drive to completion, return rid -> tokens."""
        rids = [self.submit(p, max_new) for p in prompts]
        while self.pending():
            self.step()
        return {rid: self.result(rid) for rid in rids}
