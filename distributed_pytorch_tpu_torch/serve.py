"""Continuous batching: slot-based autoregressive serving, the port of the
JAX package's serve.py ContinuousBatcher.

A fixed pool of cache slots where sequences enter (bucketed batched prefill
into a free slot, or teacher-forced inside a running block), decode in
lockstep (one ragged decode step per token for every slot) and retire
independently (EOS or length budget):

- the KV cache is either one contiguous (slots, Hkv, kv_len, Dh) buffer
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
- slot recycling needs no cache zeroing: stale rows beyond an occupant's
  write frontier are never read, and each step overwrites its row before
  the bound reaches it;
- **multi-token scheduling** (``steps_per_sync``): one ``step()`` runs a
  decode block of up to ``steps_per_sync`` lockstep steps.  The JAX
  package runs the block as one device ``while_loop``; here it is a Python
  loop whose per-slot state machine (token, position, prompt offset,
  budget, done and switch flags) stays on the device.  The block ends as
  soon as every slot is done; its results come back in one transfer;
- **in-block refill** (``inblock_refill``, default): an empty slot of a
  running pool takes a queued request whose prompt is at most
  ``inblock_admit_limit`` tokens and teacher-forces it one token per
  lockstep step, and an occupant that can retire by budget this block has
  the next queued request STAGED behind it: on retirement the slot
  switches to it in place (position 0, the staged prompt, parameters,
  budget, write cap and table row) and prefills it on the next step;
- **overlapped dispatch** (``overlap``, default): when the host can prove
  the next block needs no intervention (``_try_chain``), it is dispatched
  from the in-flight block's device-side carry BEFORE that block's results
  are parsed; emissions then arrive one ``step()`` later.  The block's
  early exit reads each step's done flag one step late (a pinned,
  non-blocking copy) so the host never waits on the step it just issued;
  the block's results are copied to pinned memory behind an event that
  ``_collect`` alone waits on;
- **chunked prefill** (``prefill_chunk``): admissions prefill one chunk
  of prompt per ``step()`` into a scratch cache, between decode blocks;
- **in-batcher speculation** (``speculate`` = n_spec): the block becomes
  a loop of speculation ROUNDS: every slot proposes n_spec tokens by
  prompt lookup from its own stream and one (slots, n_spec+1)-token
  ragged verify forward checks them all (greedy slots exact-greedy,
  temperature > 0 slots exact warped sampling by point-mass rejection);
- **per-request sampling**: temperature / top_k / top_p / eos_id are
  ``submit()`` parameters, applied per slot by ``sample_per_seq``;
- **preemption** (paged): when live sequences outgrow an oversubscribed
  pool, the youngest occupant is host-swapped (its pages copied to host
  memory, the request parked on a resume queue) and swapped back in,
  bitwise, when the pool has room;
- **prefix caching** (``prefix_cache=True``, paged): full 512-token prompt
  pages are content-addressed by chain hash (``prefix_page_hashes``) and
  SHARED across requests through the block tables with refcounts; a
  repeated system prompt admits over the cached pages and prefills only
  its suffix (one ``verify_step_ragged`` window);
- **drained-tail compaction** (``compact_tail``, paged): with no queued,
  staged or swapped work left and at most half the slots live, a block
  runs over a power-of-two number of rows holding only the live slots.

Each ``jax.random`` split of the JAX batcher is a draw from the batcher's
``torch.Generator`` here; a lockstep block with a sampled row draws its
uniforms for all ``steps_per_sync`` steps at once, so a block draws the
same whether it runs serially or chained.  Tensor parallelism (``mesh``,
``tp_axis``) and the fleet handoff (``export_request`` /
``import_request``) raise ``NotImplementedError`` naming ROADMAP.md
queue 1, slices 5d-ii and 5e.
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

FLEET_SLICE = tfm.FLEET_SLICE


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
    # set once the prompt's full pages were offered to the registry
    pages_published: bool = False
    t_submit: float = 0.0
    t_first: float | None = None  # first emission (TTFT = t_first - t_submit)
    t_done: float | None = None


@dataclass
class _Admission:
    """A request mid-prefill (chunked): its reserved slot's scratch cache
    fills one prompt chunk per ``step()``, so live slots keep decoding
    between chunks."""
    req: _Request
    cache: object                 # (1, Hkv, bucket, Dh) scratch slabs
    bucket: int
    off: int = 0                  # tokens prefilled so far
    last_logits: object = None    # set once the final chunk ran


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
    poff: int                     # prompt progress (mid-prefill victims)
    last_tok: int


@dataclass
class _InFlight:
    """A dispatched-but-not-yet-parsed lockstep block: what ``_collect``
    needs to parse its packed results, plus the device-side carry and
    staging a chained successor reuses (``_try_chain``)."""
    packed: tuple                 # (host buffer, event or None)
    k_exec: int                   # steps before every row was done
    carry: dict                   # device per-slot machine state at block end
    cur: dict                     # device staging (reusable by a chained block)
    ref: dict                     # device refill staging (ditto)
    sampled: bool                 # a row samples: the block draws uniforms
    live: list                    # slots live at dispatch
    cols: dict                    # slot -> packed column
    w: int                        # row count
    compact: bool
    npad: int
    plen: np.ndarray              # dispatch-time per-slot prompt lengths
    active0: np.ndarray           # rows already switched to their refill
    headroom: np.ndarray          # per-slot prompt-left + budget at dispatch
    upto: np.ndarray              # per-slot worst-case write frontier (paged)
    chainable: bool               # block flavour admits a chained successor
    refs_held: bool = False       # a chained successor reuses the staged refs


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
    there.  The knobs are the JAX batcher's, with its defaults: in-block
    refill and overlapped dispatch on; ``paged=True`` serves from a page
    pool (``pool_pages`` pages of 512 tokens, one of them the reserved
    scratch page; default enough for every slot at max_len), with
    preemption, ``prefix_cache`` and ``compact_tail`` as the module
    docstring describes.

    ``compact_tail`` determinism caveat (as in the JAX batcher): a
    compacted block is a narrower dispatch, so bf16 GREEDY streams can
    flip at near-ties at the compaction boundary, and SAMPLED streams
    change there in any dtype (a request's draws shift when its row
    moves).  ``compact_tail=False`` keeps every dispatch full-width when
    seeded reproducibility matters; f32 greedy is exact either way.
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
                 inblock_refill: bool = True,
                 schedule: str = "fifo",
                 compact_tail: bool = True,
                 speculate: int = 0, spec_ngram: int = 2,
                 prefix_cache: bool = False,
                 overlap: bool = True,
                 kv_dtype=None,
                 mesh=None, tp_axis: str = "model",
                 device: str | torch.device = "cuda"):
        if mesh is not None or tp_axis != "model":
            raise not_ported("mesh / tp_axis (tensor-parallel serving)",
                             gen.TP_SERVING_SLICE)
        self.device = resolve_device(device)
        # pinned host buffers and events carry device->host reads on CUDA
        self._pinned = self.device.type == "cuda"
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.kv_dtype = gen.canon_kv_dtype(kv_dtype)
        self.max_len = gen.pad_cache_len(max_len)
        # in-batcher speculation: the verify window writes up to n_spec
        # positions past the accepted frontier, so the cache gains a block
        # of headroom those garbage rows can never clamp onto live ones
        if speculate < 0:
            raise ValueError(f"speculate must be >= 0, got {speculate}")
        if speculate and spec_ngram < 1:
            raise ValueError(f"spec_ngram must be >= 1, got {spec_ngram}")
        self.n_spec = speculate
        self.spec_ngram = spec_ngram
        self.kv_len = (gen.pad_cache_len(self.max_len + speculate + 1)
                       if speculate else self.max_len)
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
        if prefill_chunk is not None:
            if prefill_chunk < 1:
                raise ValueError(f"prefill_chunk must be >= 1, got "
                                 f"{prefill_chunk}")
            bad = [b for b in self.buckets if b % prefill_chunk]
            if bad:
                raise ValueError(
                    f"prefill_chunk {prefill_chunk} must divide every "
                    f"prompt bucket (violates {bad})")
        self.prefill_chunk = prefill_chunk
        self.kv_heads = params["layers.0.wk"].shape[1]
        kv_kw = dict(dtype=dtype or torch.float32, kv_heads=self.kv_heads,
                     kv_dtype=self.kv_dtype, device=self.device)
        self.paged = paged
        self.page = 512
        self.pages_per_slot = self.kv_len // self.page
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
        else:
            self.cache = gen.init_cache(cfg, slots, self.kv_len, **kv_kw)
        self.prefix_cache = prefix_cache
        if prefix_cache:
            if not paged:
                raise ValueError("prefix_cache requires paged=True (the "
                                 "sharing rides the block tables)")
            if prefill_chunk is not None:
                raise ValueError(
                    "prefix_cache does not compose with prefill_chunk: "
                    "chunked admission re-prefills every prompt and "
                    "would silently never share pages")
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
        self.admitting: dict[int, _Admission] = {}  # slot -> chunked prefill
        self.queue: deque[_Request] = deque()
        self.requests: dict[int, _Request] = {}
        self._next_rid = 0
        # in-block refill: per-slot prompt progress of the CURRENT occupant
        # (poff >= len(prompt) = prefill complete), plus the staged
        # next-in-line request per slot
        self.inblock_refill = inblock_refill
        self.refill_width = self.buckets[-1]  # in-block prompt buffer
        # in-block ADMISSION teacher-forces one token per lockstep step, so
        # it takes only prompts on the order of a block (or a chunk);
        # the retire -> refill HANDOFF takes the whole buffer width
        self.inblock_admit_limit = min(
            self.refill_width,
            max(steps_per_sync, prefill_chunk or steps_per_sync))
        if schedule not in ("fifo", "longest_first"):
            raise ValueError(f"unknown schedule {schedule!r}: expected "
                             f"'fifo' or 'longest_first'")
        self.schedule = schedule
        self._queue_dirty = False
        self.compact_tail = compact_tail
        self.overlap = overlap
        self._inflight: _InFlight | None = None
        self._break_chain = False
        self._flags = None   # pinned per-step done flags (overlap, CUDA)
        self.slot_poff = np.zeros(slots, np.int32)
        self.staged_refill: list[_Request | None] = [None] * slots
        self._staged_order: list[int] = []
        if paged:
            self.refill_pages: list[list[int]] = [[] for _ in range(slots)]
            self.r_table = np.zeros((slots, self.pages_per_slot), np.int32)
            # preemption: victims host-swap their pages and wait here;
            # admission sequence numbers pick the YOUNGEST victim
            self.swapped: deque[_Swapped] = deque()
            self.slot_admit_seq = np.zeros(slots, np.int64)
            self._admit_counter = 0
        # per-phase wall clock: host_plan / prefill / dispatch / fetch /
        # host_parse (timing_stats)
        self.timers = PhaseTimer()
        # accounting, as the JAX batcher keeps it: slot-steps dispatched
        # vs tokens delivered (inblock_prefill_steps: slot-steps spent
        # teacher-forcing a prompt), preemption, compaction, chaining,
        # speculation and prefix-cache events.  decode_steps is the port's
        # own: the lockstep steps the device ran, which under overlap
        # include a block's one step past its early exit
        self.stats = {"decode_dispatches": 0, "decode_steps": 0,
                      "slot_steps": 0, "emitted_tokens": 0,
                      "wasted_slot_steps": 0, "prefill_dispatches": 0,
                      "batch_admissions": 0, "inblock_prefill_steps": 0,
                      "inblock_refills": 0, "evictions": 0, "swap_ins": 0,
                      "compact_dispatches": 0, "chained_dispatches": 0,
                      "spec_rounds": 0, "spec_proposed": 0,
                      "spec_accepted": 0, "prefix_hits": 0,
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
        return (bool(self.queue) or bool(self.admitting)
                or (self.paged and bool(self.swapped))
                or self._inflight is not None
                or any(o is not None for o in self.occupant))

    def queue_depth(self) -> int:
        """Requests accepted but not yet generating (queued + mid chunked
        admission)."""
        return len(self.queue) + len(self.admitting)

    def timing_stats(self) -> dict:
        """Per-phase wall-clock summary over every ``step()`` so far:
        ``host_plan`` (admission, swap-in, page planning and staging),
        ``prefill`` (admission prefills), ``dispatch`` (issuing a decode
        block's steps, including the early-exit reads), ``fetch`` (waiting
        for a block's device->host transfer), ``host_parse`` (emission
        bookkeeping).  Under ``overlap`` a block's fetch and parse run
        while its chained successor computes."""
        return self.timers.summary()

    def result(self, rid: int) -> np.ndarray:
        req = self.requests[rid]
        return np.concatenate([req.prompt,
                               np.asarray(req.emitted, np.int32)])

    def latency_stats(self) -> dict[str, float]:
        """Per-request latency percentiles over COMPLETED requests, in
        seconds of host clock (``ttft_*``: submit -> first emission;
        ``total_*``: submit -> retirement).  A token's time is that of the
        parse that delivered it.  With none completed, returns
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
        """Dispatched slot-step utilization: (sampled emissions from decode
        blocks + in-block teacher-forced prefill steps) / dispatched
        slot-steps.  Each batch-prefilled admission's first token came
        from its prefill, not a slot-step.  Under speculation
        ``slot_steps`` counts verify positions, so this reads low by
        design; ``emitted_per_slot_step`` is the acceptance-adjusted
        number.  0.0 before the first block."""
        s = self.stats
        if s["slot_steps"] == 0:
            return 0.0
        return ((s["emitted_tokens"] - s["batch_admissions"]
                 + s["inblock_prefill_steps"]) / s["slot_steps"])

    def emitted_per_slot_step(self) -> float:
        """Sampled emissions delivered per dispatched slot-step (the
        ``utilization`` denominator, emissions alone in the numerator):
        under speculation, emissions per verify position.  0.0 before the
        first block."""
        s = self.stats
        if s["slot_steps"] == 0:
            return 0.0
        return ((s["emitted_tokens"] - s["batch_admissions"])
                / s["slot_steps"])

    def _flush_inflight(self) -> list[tuple[int, int]]:
        """Collect the overlapped in-flight block (if any) serially, so the
        host bookkeeping is caught up with the device.  Emissions land in
        each request's ``emitted`` list and are returned."""
        out: list[tuple[int, int]] = []
        fl, self._inflight = self._inflight, None
        if fl is not None:
            out += self._collect(fl)
        return out

    def export_request(self, rid: int):
        raise not_ported("export_request (fleet KV handoff)", FLEET_SLICE)

    def import_request(self, state: dict):
        raise not_ported("import_request (fleet KV handoff)", FLEET_SLICE)

    # -- device transfers -------------------------------------------------
    def _dev(self, a) -> torch.Tensor:
        """A host array as a tensor on the batcher's device (a copy: the
        host mirrors change while a block is in flight)."""
        return torch.from_numpy(np.array(a)).to(self.device)

    def _start_fetch(self, packed: torch.Tensor) -> tuple:
        """Start the device->host copy of a block's packed results: into
        pinned memory, non-blocking, behind an event on CUDA (waiting on
        the stream would also wait for a chained successor)."""
        if not self._pinned:
            return packed, None
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    @staticmethod
    def _finish_fetch(handle: tuple) -> np.ndarray:
        host, ev = handle
        if ev is not None:
            ev.synchronize()
        return host.numpy().copy()

    def _flag(self, done: torch.Tensor, i: int) -> tuple:
        """Start reading ``all(done)`` after step ``i`` of a block: a
        non-blocking copy into pinned slot ``i`` behind an event on CUDA,
        the value itself elsewhere."""
        t = done.all()
        if not self._pinned:
            return t, None
        if self._flags is None:
            self._flags = torch.zeros(self.steps_per_sync + 1,
                                      dtype=torch.bool, pin_memory=True)
        self._flags[i].copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return self._flags[i], ev

    @staticmethod
    def _read_flag(handle: tuple) -> bool:
        t, ev = handle
        if ev is not None:
            ev.synchronize()
        return bool(t)

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

    def _write_caps(self, pages: list[list[int]] | None = None
                    ) -> np.ndarray:
        """Per-slot last writable position: the allocated frontier under
        paging (in-block writes must never dereference unowned table
        entries), kv_len-1 for the dense cache.  ``pages`` defaults to the
        occupants' page lists; ``self.refill_pages`` gives the staged
        refills' caps."""
        if not self.paged:
            return np.full(self.slots, self.kv_len - 1, np.int32)
        return np.asarray(
            [max(len(p) * self.page - 1, 0)
             for p in (self.slot_pages if pages is None else pages)],
            np.int32)

    def _block_writes(self, pr: int, rem: int) -> int:
        """Worst-case cache writes ONE dispatch can make for a slot with
        ``pr`` prompt tokens left and ``rem`` emission budget: K lockstep
        steps, or under speculation R rounds advancing up to W = n_spec+1
        positions each (bounded by pr + rem) plus the W-wide tail the
        verify window writes past the frontier."""
        k = self.steps_per_sync
        if self.n_spec:
            w_ = self.n_spec + 1
            return min(k * w_, pr + rem) + w_
        return min(k, pr + min(k, rem))

    def _pages_short(self, upto_pos: int, owned: int = 0) -> int:
        """How many pages the pool must supply to cover positions
        [0, upto_pos] given ``owned`` pages already held."""
        return min(upto_pos // self.page + 1, self.pages_per_slot) - owned

    def _alloc_refill_pages(self, slot: int) -> bool:
        """Reserve pages for a staged refill's worst-case in-block writes
        (it switches in at step >= 1, so at most steps_per_sync - 1
        positions; under speculation W positions a round from 0 plus the
        W-wide tail).  Returns False when the pool cannot cover them: the
        request then stays queued."""
        k = self.steps_per_sync
        if self.n_spec:
            w_ = self.n_spec + 1
            upto = min(k * w_ + w_ - 1, self.kv_len - 1)
        else:
            upto = min(max(k - 2, 0), self.kv_len - 1)
        need = self._pages_short(upto)
        if self._avail_pages() < need:
            return False
        pages = [self._take_free_page() for _ in range(need)]
        self.refill_pages[slot] = pages
        self.r_table[slot, :] = 0
        self.r_table[slot, :need] = pages
        return True

    def _release_refill_pages(self, slot: int) -> None:
        self.free_pages.extend(self.refill_pages[slot])
        self.refill_pages[slot] = []
        self.r_table[slot, :] = 0

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
        req.pages_published = True

    def _maybe_publish_prompt_pages(self, slot: int,
                                    req: _Request | None = None, *,
                                    prompt_done: bool | None = None
                                    ) -> None:
        """Publish hook for prompts prefilled INSIDE the decode block
        (in-block admissions and refill handoffs never pass through
        ``_fill_free_slots``'s registration).  Safe once the prompt is
        fully written: in-block writes are contiguous from position 0, and
        garbage writes land at or beyond the prompt length.
        ``prompt_done=True`` (retirement: an emission implies the prompt
        was consumed) skips the host-progress check."""
        if not self.prefix_cache:
            return
        req = req if req is not None else self.occupant[slot]
        if req is None or req.pages_published or not req.prefix_hashes:
            return
        if prompt_done is None:
            prompt_done = self.slot_poff[slot] >= len(req.prompt)
        if (not prompt_done
                or len(self.slot_pages[slot]) < len(req.prefix_hashes)):
            return
        self._register_prompt_pages(slot, req)

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
        wcap = min(L, self.kv_len - 1)
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
        joins the resume queue; the pages go back to the pool.  The
        request continues mid-generation (or mid-prompt) on swap-in."""
        occ = self.occupant[victim]
        pids = torch.tensor(self.slot_pages[victim], device=self.device)
        kv = [leaf[pids].cpu() for leaf in self._leaves()]
        self.swapped.append(_Swapped(
            req=occ, kv=kv, n_pages=len(self.slot_pages[victim]),
            pos=int(self.pos[victim]), poff=int(self.slot_poff[victim]),
            last_tok=int(self.last_tok[victim])))
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
            if self.occupant[slot] is not None or slot in self.admitting:
                continue
            sw = self.swapped[0]
            pr = max(len(sw.req.prompt) - sw.poff, 0)
            rem = sw.req.max_new - len(sw.req.emitted)
            writes = self._block_writes(pr, rem)
            base = sw.poff if pr else sw.pos + 1
            upto = min(base + writes - 1, self.kv_len - 1)
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
            self.slot_poff[slot] = sw.poff
            self.last_tok[slot] = sw.last_tok
            self._alloc_pages(slot, upto)
            self.stats["swap_ins"] += 1

    def _hold_for_resume(self) -> bool:
        """True while a preempted request waits on the resume queue: every
        page-consuming admission holds so freed pages accumulate for the
        oldest victim's swap-in instead of being taken by younger
        arrivals."""
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
        slab = self._scratch_cache(bucket)
        logits, slab = gen._forward_cached(
            self.params, slab, padded,
            torch.arange(bucket, device=self.device), 0, cfg=self.cfg,
            dtype=self.dtype, k_len=bucket, unembed_at=L - 1)
        return logits[0, 0], slab

    def _scratch_cache(self, bucket: int):
        return gen.init_cache(self.cfg, 1, bucket,
                              dtype=self.dtype or torch.float32,
                              kv_heads=self.kv_heads, kv_dtype=self.kv_dtype,
                              device=self.device)

    def _prefill_chunk(self, adm: _Admission) -> torch.Tensor:
        """One ``prefill_chunk``-token chunk of ``adm``'s prompt, written at
        scratch offset ``adm.off`` and attending causally to everything
        already prefilled (k_len = the bucket).  Returns the (vocab,)
        logits at the last true prompt position for the final chunk, at
        the chunk's first row otherwise (discarded)."""
        c, dev = self.prefill_chunk, self.device
        prompt, L = adm.req.prompt, len(adm.req.prompt)
        if adm.cache is None:
            adm.cache = self._scratch_cache(adm.bucket)
        chunk = torch.zeros((1, c), dtype=torch.long, device=dev)
        take = min(c, L - adm.off)
        chunk[0, :take] = torch.from_numpy(
            prompt[adm.off:adm.off + take].astype(np.int64))
        final = adm.off + c >= L
        logits, adm.cache = gen._forward_cached(
            self.params, adm.cache, chunk,
            adm.off + torch.arange(c, device=dev), adm.off, cfg=self.cfg,
            dtype=self.dtype, k_len=adm.bucket,
            unembed_at=(L - 1 - adm.off) if final else 0)
        return logits[0, 0]

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
        """Install a batch-prefilled request into its slot and emit
        token 0 (its K/V is already in the pool; prefill complete)."""
        self.occupant[slot] = req
        self.pos[slot] = len(req.prompt) - 1
        self.slot_poff[slot] = len(req.prompt)
        self._set_slot_params(slot, req)
        self.stats["batch_admissions"] += 1
        self._emit(slot, first_tok, out)

    def _occupy_prefilling(self, slot: int, req: _Request) -> bool:
        """Install a queued request into an empty slot with NO prefill
        done: its prompt is teacher-forced inside the decode block (in-block
        admission).  Under paging, reserves pages for the first block's
        writes; returns False (request stays queued) when the pool cannot
        cover them."""
        if self.paged:
            upto = self._block_writes(len(req.prompt), req.max_new) - 1
            upto = min(upto, self.kv_len - 1)
            if self._avail_pages() < self._pages_short(upto):
                return False
            self._alloc_pages(slot, upto)
        self.occupant[slot] = req
        self.pos[slot] = 0
        self.slot_poff[slot] = 0
        self.last_tok[slot] = 0
        self._set_slot_params(slot, req)
        return True

    def _install_refill(self, slot: int, req: _Request) -> None:
        """The device switched this slot to its staged refill mid-block:
        mirror that on the host (the refill becomes the occupant; under
        paging its reserved pages become the slot's pages)."""
        self.occupant[slot] = req
        self._set_slot_params(slot, req)
        if self.paged:
            self.slot_pages[slot] = self.refill_pages[slot]
            self.refill_pages[slot] = []
            self.table[slot, :] = self.r_table[slot]
            self.r_table[slot, :] = 0

    def _fill_free_slots(self) -> list[tuple[int, int]]:
        """Unchunked admission: prefill queued requests into free slots,
        one bucketed prefill each (a suffix prefill over cached pages under
        prefix caching); returns the (rid, first token) pairs.  When the
        page pool cannot hold the prompt, or a preempted request waits to
        resume, the queue WAITS instead of raising."""
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
                upto = min(L, self.kv_len - 1) if shared else L - 1
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

    def _advance_admissions(self) -> list[tuple[int, int]]:
        """Chunked admission: reserve free slots for queued requests, then
        push ONE prompt chunk per admitting slot (each a short dispatch:
        live slots decode between calls instead of waiting out a whole
        prompt).  Finished admissions install into their slot and emit
        their first token."""
        for slot in range(self.slots):
            if self._hold_for_resume():
                # _resume_swapped skips admitting slots: a reservation
                # here would sit idle behind its own held install
                break
            if (self.occupant[slot] is None and slot not in self.admitting
                    and self.queue):
                req = self.queue.popleft()
                bucket = next(b for b in self.buckets
                              if b >= len(req.prompt))
                self.admitting[slot] = _Admission(req, None, bucket)
        out: list[tuple[int, int]] = []
        for slot, adm in list(self.admitting.items()):
            req, L = adm.req, len(adm.req.prompt)
            if adm.last_logits is None:
                last_logits = self._prefill_chunk(adm)
                self.stats["prefill_dispatches"] += 1
                adm.off += self.prefill_chunk
                if adm.off >= L:
                    adm.last_logits = last_logits
            if adm.last_logits is not None:
                # prefill complete: install, or HOLD the finished slabs
                # while the pool cannot take the prompt (or a preempted
                # request waits) and retry next step
                if self.paged:
                    if (self._hold_for_resume()
                            or self._avail_pages()
                            < self._pages_short(L - 1)):
                        continue
                    self._alloc_pages(slot, L - 1)
                    self._insert_paged(adm.cache, slot)
                else:
                    self._insert(adm.cache, slot)
                del self.admitting[slot]
                self._occupy(slot, req,
                             self._sample_first(req, adm.last_logits), out)
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
                # a prompt that completed and retired inside ONE block
                # never reached the continuing-slot publish hook
                self._maybe_publish_prompt_pages(slot, req,
                                                 prompt_done=True)
                self._release_pages(slot)
        else:
            self.last_tok[slot] = tok

    def _stage_refills(self) -> None:
        """Pop queued requests behind occupants that can retire by BUDGET
        this block, so the device can hand their slot over in place
        (every prompt fits the in-block buffer: ``submit`` rejects prompts
        over the largest bucket == ``refill_width``).  Unused staged
        requests return to the queue front after the block.  Occupants
        whose only retirement path this block is an armed eos are not
        staged behind: whether it fires is unknowable here."""
        if self._hold_for_resume():
            # preempted requests are OLDEST and need a pages-restore before
            # decoding, which the in-block handoff cannot do
            return
        k = self.steps_per_sync
        for slot in range(self.slots):
            if not self.queue:
                break
            if self.prefix_cache and self._prefix_lookup(self.queue[0]):
                # a cached prefix admits batched over the shared pages
                # instead of teacher-forcing the whole prompt
                break
            occ = self.occupant[slot]
            if (occ is None or slot in self.admitting
                    or self.staged_refill[slot] is not None):
                continue
            pr = max(len(occ.prompt) - int(self.slot_poff[slot]), 0)
            rem = occ.max_new - len(occ.emitted)
            if pr + rem > k:
                continue  # cannot retire by budget this block
            if self.paged and not self._alloc_refill_pages(slot):
                break
            self.staged_refill[slot] = self.queue.popleft()
            self._staged_order.append(slot)

    def _requeue_unused_refills(self) -> None:
        for slot in reversed(self._staged_order):
            req = self.staged_refill[slot]
            if req is not None:
                self.staged_refill[slot] = None
                if self.paged:
                    self._release_refill_pages(slot)
                self.queue.appendleft(req)
        self._staged_order.clear()

    @staticmethod
    def _req_fields(req: _Request):
        """(temp, top_k, top_p, eos, budget) staging vectors' entries."""
        return (req.temperature, req.top_k, req.top_p,
                -1 if req.eos_id is None else req.eos_id, req.max_new)

    # -- the decode blocks ------------------------------------------------
    def _decode_block(self, cur: dict, ref: dict, carry: dict, w: int,
                      sampled: bool):
        """Run up to ``steps_per_sync`` lockstep ragged decode steps over
        ``w`` rows.  Returns (the packed results' fetch handle, the carry
        at block end, the number of steps before every row was done).

        Each row is the JAX batcher's state machine (``_decode_for``),
        driven by ``cur`` (the current request: prompt buffer and length,
        sampling parameters, write cap, table row) and ``ref`` (the staged
        NEXT request, the same fields plus ``valid`` and ``budget``), with
        its per-step state in ``carry`` (input token, write position,
        prompt offset, remaining budget, done and active flags, last
        meaningful write):

        - while ``poff < plen`` the row is PREFILLING: its input is
          ``prompt[poff]``, its sample discarded except at the last prompt
          position, whose sample is the request's first emission;
        - then it DECODES: each sampled token feeds the next step;
        - on retirement (eos sampled, or budget exhausted) with a valid
          ``ref``, it SWITCHES in place: position 0, the refill's prompt,
          parameters, budget, cap and table row take over.

        The loop ends once every row is done.  Under ``overlap`` it reads
        each step's done flag one step late (the host issues step i, then
        waits for step i-1's flag), so a block that exits early runs one
        more step, in which every row is done: it emits nothing and its
        writes clamp at each row's cap, as a done row's lockstep writes
        always do.  ``decode_steps`` counts it; the JAX accounting
        (``slot_steps`` and the rest) does not.  A block with a sampled
        row draws its uniforms for all ``steps_per_sync`` steps up front,
        so the generator advances the same either way."""
        dev, k, width = self.device, self.steps_per_sync, self.refill_width
        paged = self.paged
        tok, pos, poff = carry["tok"], carry["pos"], carry["poff"]
        rem, active, lw = carry["rem"], carry["active"], carry["lw"]
        done = carry["done"] | (rem <= 0)
        buf = torch.zeros((k, w), dtype=torch.int32, device=dev)
        mask = torch.zeros((k, w), dtype=torch.bool, device=dev)
        sw = torch.full((w,), k + 1, dtype=torch.int32, device=dev)
        pf = torch.zeros((w,), dtype=torch.int32, device=dev)
        noise = (torch.rand((k, w, self.cfg.vocab_size),
                            generator=self.generator, device=dev)
                 if sampled else None)
        lag = self.overlap
        flags = [self._flag(done, 0)] if lag else None
        k_exec, steps = k, 0
        for i in range(k):
            if not lag and bool(done.all()):
                k_exec = i
                break
            plen_eff = torch.where(active, ref["plen"], cur["plen"])
            in_pf = poff < plen_eff
            pidx = torch.clamp(poff, max=width - 1).long()[:, None]
            ptok = torch.where(active,
                               torch.gather(ref["prompt"], 1, pidx)[:, 0],
                               torch.gather(cur["prompt"], 1, pidx)[:, 0])
            itok = torch.where(in_pf, ptok, tok)
            cap_eff = torch.where(active, ref["cap"], cur["cap"])
            table_eff = (torch.where(active[:, None], ref["table"],
                                     cur["table"]) if paged else None)
            logits, _ = gen.decode_step_ragged(
                self.params, self.cache, itok.long(), pos, cfg=self.cfg,
                dtype=self.dtype, use_decode_kernel=self.use_kernel,
                page_table=table_eff)
            if sampled:
                toks = gen.sample_per_seq(
                    None, logits,
                    torch.where(active, ref["temp"], cur["temp"]),
                    torch.where(active, ref["top_k"], cur["top_k"]),
                    torch.where(active, ref["top_p"], cur["top_p"]),
                    u=noise[i])
            else:
                toks = torch.argmax(logits, -1).to(torch.int32)
            # the last prompt position's sample is the first emission;
            # earlier prefill steps discard theirs
            last_pf = in_pf & (poff + 1 >= plen_eff)
            emit = ~done & (~in_pf | last_pf)
            buf[i] = toks
            mask[i] = emit
            pf = pf + (~done & in_pf & ~last_pf).to(torch.int32)
            rem = rem - emit.to(torch.int32)
            eos_eff = torch.where(active, ref["eos"], cur["eos"])
            fin = emit & (((toks == eos_eff) & (eos_eff >= 0)) | (rem <= 0))
            switch = fin & ~active & ref["valid"]
            # last meaningful write (done rows' writes are clamped garbage)
            lw = torch.where(done, lw, pos)
            done = done | (fin & ~switch)
            poff = torch.where(in_pf, poff + 1, poff)
            pos = torch.minimum(pos + 1, cap_eff)
            # in-place handoff: the refill takes over at position 0
            poff = torch.where(switch, 0, poff)
            pos = torch.where(switch, 0, pos)
            rem = torch.where(switch, ref["budget"], rem)
            active = active | switch
            sw = torch.where(switch, i + 1, sw)
            tok = toks
            steps += 1
            if lag:
                flags.append(self._flag(done, i + 1))
                if self._read_flag(flags[i]):
                    k_exec = i  # step i ran with every row done
                    break
        self.stats["decode_steps"] += steps
        packed = torch.cat([buf.reshape(-1),
                            mask.to(torch.int32).reshape(-1),
                            sw, lw, poff, pf])
        carry = dict(tok=tok, pos=pos, poff=poff, rem=rem, done=done,
                     active=active, lw=lw)
        return self._start_fetch(packed), carry, k_exec

    def _decode_spec_block(self, cur: dict, ref: dict, w: int,
                           gather_cols: int, sampled: bool):
        """SPECULATIVE decode block (the JAX batcher's ``_decode_spec_for``):
        up to ``steps_per_sync`` speculation ROUNDS.  Each round, every
        row proposes ``n_spec`` tokens by prompt lookup from its own
        stream, joins ONE (w, W = n_spec+1)-token ragged verify forward
        (reference attention, as in JAX), and accepts the longest correct
        prefix: greedy rows match the argmax, temperature > 0 rows run
        point-mass rejection (accept proposal x with probability p(x),
        resample from p without x), and the frontier token comes from the
        last accepted position's logits.

        The row state is (``stream``, ``det``, ``wr``): the known tokens at
        their positions, their count, and the cache frontier.  Positions
        [wr, min(wr+W, det)-1] are known (teacher-forced prefill rides the
        same window at W tokens a round), later window entries are
        proposals.  Writes clamp at ``cap``; retirement hands off in place
        to the staged refill as in the lockstep block.  ``gather_cols``
        (paged) bounds the verify's pool gather to that many table
        columns.  Returns (the packed results as a host array, the rounds
        run)."""
        dev, r_max = self.device, self.steps_per_sync
        wk, ngram = self.n_spec + 1, self.spec_ngram
        width, kv_len, vocab = self.refill_width, self.kv_len, \
            self.cfg.vocab_size
        k_hint = gather_cols * self.page if self.paged and gather_cols \
            else None
        ref_stream = torch.zeros((w, kv_len), dtype=torch.int32, device=dev)
        ref_stream[:, :width] = ref["prompt"]
        stream, det, wr, rem = cur["stream"], cur["det"], cur["wr"], \
            cur["rem"]
        active = torch.zeros((w,), dtype=torch.bool, device=dev)
        done = rem <= 0
        etok = torch.zeros((r_max, w, wk), dtype=torch.int32, device=dev)
        ecnt = torch.zeros((r_max, w), dtype=torch.int32, device=dev)
        sw = torch.full((w,), r_max + 1, dtype=torch.int32, device=dev)
        pf = torch.zeros((w,), dtype=torch.int32, device=dev)
        prop_n = torch.zeros((), dtype=torch.int64, device=dev)
        prop_acc = torch.zeros((), dtype=torch.int64, device=dev)
        grid = torch.arange(wk, device=dev)[None]
        jj = grid + 1                        # 1..W
        jj2 = jj[:, :-1]                     # 1..W-1
        n_exec = 0

        def sel(key):  # the row's current request, or its switched-in refill
            return torch.where(active, ref[key], cur[key])

        for i in range(r_max):
            if bool(done.all()):
                break
            live = ~done
            plen_eff, eos_eff, cap_eff = sel("plen"), sel("eos"), sel("cap")
            table_eff = (torch.where(active[:, None], ref["table"],
                                     cur["table"]) if self.paged else None)
            # 1. prompt-lookup proposals from each row's stream
            props = gen.lookup_proposals(stream, det - 1, wk - 1, ngram)
            # 2. the input window: known stream tokens, proposals beyond
            idx = wr[:, None] + grid
            known = idx < det[:, None]
            stream_at = torch.gather(stream, 1,
                                     torch.clamp(idx, 0, kv_len - 1).long())
            prop_at = torch.gather(props, 1, torch.clamp(
                idx - det[:, None], 0, wk - 2).long())
            inp = torch.where(known, stream_at, prop_at)
            wpos = torch.minimum(idx, cap_eff[:, None])
            logits, _ = gen.verify_step_ragged(
                self.params, self.cache, inp.long(), idx, wpos, cfg=self.cfg,
                dtype=self.dtype, page_table=table_eff, k_len=k_hint)
            # 3. accept: greedy match or point-mass rejection
            g = torch.argmax(logits, -1).to(torch.int32)
            x_next = inp[:, 1:]
            if sampled:
                temp_eff = sel("temp")
                masked = gen.filter_per_seq(
                    logits.reshape(w * wk, vocab),
                    temp_eff.repeat_interleave(wk),
                    sel("top_k").repeat_interleave(wk),
                    sel("top_p").repeat_interleave(wk)).reshape(w, wk, vocab)
                probs = torch.softmax(masked, -1)
                px = torch.gather(probs[:, :-1], 2,
                                  x_next.long()[..., None])[..., 0]
                u = torch.rand((w, wk - 1), generator=self.generator,
                               device=dev)
                greedy_row = (temp_eff <= 0.0)[:, None]
                ok_prop = torch.where(greedy_row, x_next == g[:, :-1],
                                      u < px)
            else:
                ok_prop = x_next == g[:, :-1]
            ok = known[:, 1:] | ok_prop
            m = torch.cumprod(ok.to(torch.int32), 1).sum(1)   # [0, W-1]
            f = torch.gather(g, 1, m[:, None].long())[:, 0]
            if sampled:
                # residual sample at the rejection point, bonus draw on a
                # full accept
                viota = torch.arange(vocab, device=dev)
                repl_logits = torch.where(viota == x_next[..., None],
                                          gen.NEG_INF, masked[:, :-1])
                repl = gen._gumbel_argmax(
                    self.generator, repl_logits.reshape(-1, vocab)).reshape(
                        w, wk - 1).to(torch.int32)
                bonus = gen._gumbel_argmax(self.generator,
                                           masked[:, -1]).to(torch.int32)
                f_samp = torch.where(m == wk - 1, bonus, torch.gather(
                    repl, 1, torch.clamp(m, 0, wk - 2)[:, None].long())[:, 0])
                f = torch.where(greedy_row[:, 0], f, f_samp)
            # 4. advance: accepted proposals + frontier into the stream,
            # emissions capped by eos and budget
            wr_new = wr + m + 1
            det_new = torch.maximum(det, wr_new + 1)
            inp_sh = torch.cat([inp[:, 1:], f[:, None]], 1)
            val = torch.where(jj <= m[:, None], inp_sh, f[:, None])
            posw = wr[:, None] + jj
            write_ok = (live[:, None] & (jj <= (m + 1)[:, None])
                        & ~((jj == (m + 1)[:, None]) & (posw < det[:, None]))
                        & (posw < kv_len))
            wide = torch.cat([stream, torch.zeros_like(stream[:, :1])], 1)
            wide.scatter_(1, torch.where(write_ok, posw, kv_len).long(),
                          torch.where(write_ok, val, 0).to(torch.int32))
            stream_new = wide[:, :kv_len]
            e_new = torch.where(live, det_new - det, 0)
            eidx = torch.clamp(det[:, None] + grid, 0, kv_len - 1)
            echunk = torch.gather(stream_new, 1, eidx.long())
            evalid = grid < e_new[:, None]
            is_eos = ((echunk == eos_eff[:, None]) & (eos_eff >= 0)[:, None]
                      & evalid)
            has_eos = is_eos.any(1)
            first_eos = torch.argmax(is_eos.to(torch.int32), 1)
            n1 = torch.where(has_eos, torch.minimum(e_new, first_eos + 1),
                             e_new)
            n_allow = torch.minimum(n1, rem)
            rem_new = rem - n_allow
            fin = live & ((rem_new <= 0) | (has_eos & (first_eos < n_allow)))
            etok[i] = echunk
            ecnt[i] = n_allow
            pf = pf + torch.where(live, torch.clamp(
                torch.minimum(wr_new, plen_eff)
                - torch.minimum(wr, plen_eff), min=0), 0)
            prop_used = live[:, None] & ~known[:, 1:]
            prop_n = prop_n + prop_used.sum()
            prop_acc = prop_acc + (prop_used & (jj2 <= m[:, None])).sum()
            # 5. retire / in-place handoff to the staged refill
            switch = fin & ~active & ref["valid"]
            done = done | (fin & ~switch)
            stream = torch.where(switch[:, None], ref_stream, stream_new)
            det = torch.where(switch, ref["plen"],
                              torch.where(live, det + n_allow, det))
            wr = torch.where(switch, 0, torch.where(live, wr_new, wr))
            rem = torch.where(switch, ref["budget"], rem_new)
            active = active | switch
            sw = torch.where(switch, i + 1, sw)
            n_exec += 1
        packed = torch.cat([t.to(torch.int32) for t in (
            etok.reshape(-1), ecnt.reshape(-1), sw, wr, pf, prop_n[None],
            prop_acc[None])])
        return self._finish_fetch(self._start_fetch(packed)), n_exec

    # -- scheduling -------------------------------------------------------
    def step(self) -> list[tuple[int, int]]:
        """Admit queued work, then run one decode block (up to
        ``steps_per_sync`` lockstep steps, or speculation rounds) for the
        whole pool.

        With ``inblock_refill`` (default) an empty slot of a running pool
        takes a short queued request and teacher-forces its prompt inside
        the block, and a slot whose occupant retires mid-block hands over
        to a staged next request in place.  Batched (bucketed or chunked)
        prefill serves an idle pool and longer prompts.

        With ``overlap`` (default) a block's results are parsed on the
        NEXT ``step()``, and when the host can prove the next block needs
        no intervention it is dispatched from the in-flight block's device
        carry BEFORE that parse.  Emissions then arrive one call later;
        streams and stats totals are unchanged.

        Returns the (rid, token) pairs emitted this call, in per-slot
        sampling order."""
        out: list[tuple[int, int]] = []
        fl, self._inflight = self._inflight, None
        if fl is not None:
            nfl = self._try_chain(fl)
            if nfl is not None:
                fl.refs_held = True
                self._break_chain = False
                out += self._collect(fl)
                if self._break_chain:
                    # the parse revealed an occupancy change: the chained
                    # block is exact, but its metadata is stale for a
                    # further chain
                    nfl.chainable = False
                self._inflight = nfl
                return out
            out += self._collect(fl)
        nfl = self._plan_dispatch(out)
        if nfl is not None:
            if self.overlap:
                self._inflight = nfl  # parsed (and maybe chained) next call
            else:
                out += self._collect(nfl)
        return out

    def _try_chain(self, fl: _InFlight) -> _InFlight | None:
        """Dispatch the successor of the in-flight block ``fl`` directly
        from its device carry, when the host provably has no intervention
        to make between the two blocks:

        - no admission could happen (no chunked admission or swapped
          request waiting; no empty slot while the queue holds work);
        - every live slot either cannot retire within ``fl`` plus the
          chained block (``headroom > 2K``) or retires into an already
          staged refill (whose reserved pages must cover 2K - 1 writes: a
          parsed handoff breaks the chain after one chained block);
        - under paging, the pool covers one more block's worst-case writes
          for every continuing row without evicting anyone.

        Returns the new in-flight record, or None to fall back to the
        serial plan -> dispatch -> parse order."""
        if not (self.overlap and fl.chainable):
            return None
        if self.admitting or (self.paged and self.swapped):
            return None
        if self.queue and any(self.occupant[s] is None and s not in fl.live
                              for s in range(self.slots)):
            return None  # an empty slot could admit queued work
        k = self.steps_per_sync
        staged = np.zeros(self.slots, bool)
        for s in fl.live:
            if fl.headroom[s] > 2 * k:
                continue
            if self.staged_refill[s] is None:
                return None  # could retire with nothing staged
            staged[s] = True
            if self.paged and 2 * k - 1 > \
                    len(self.refill_pages[s]) * self.page - 1:
                return None
        upto = fl.upto.copy()
        if self.paged and not self._chain_pages(fl, staged, upto):
            return None
        with self.timers.phase("dispatch"):
            cur = fl.cur
            if self.paged:
                # tables and caps may have grown in _chain_pages
                cur = dict(fl.cur)
                cur["table"] = self._dev(self.table)
                cur["cap"] = self._dev(self._write_caps())
            packed, carry, k_exec = self._decode_block(
                cur, fl.ref, fl.carry, fl.w, fl.sampled)
        self.stats["chained_dispatches"] += 1
        return _InFlight(
            packed=packed, k_exec=k_exec, carry=carry, cur=cur, ref=fl.ref,
            sampled=fl.sampled, live=fl.live, cols=fl.cols, w=fl.w,
            compact=False, npad=0, plen=fl.plen,
            active0=fl.active0 | staged,
            headroom=np.maximum(fl.headroom - k, 0), upto=upto,
            chainable=True)

    def _chain_pages(self, fl: _InFlight, staged: np.ndarray,
                     upto: np.ndarray) -> bool:
        """Extend continuing rows' page tables to cover one more block's
        worst-case writes WITHOUT evicting (an eviction is an intervention:
        the chain declines instead).  Rows handing off to a staged refill
        are skipped: their writes land in the refill's reserved pages."""
        plans = []
        need = 0
        for s in fl.live:
            if staged[s]:
                continue
            up = min(int(fl.upto[s]) + self.steps_per_sync,
                     self.kv_len - 1)
            short = self._pages_short(up, len(self.slot_pages[s]))
            if short > 0:
                plans.append((s, up))
                need += short
            upto[s] = up
        if need > self._avail_pages():
            return False
        for s, up in plans:
            self._alloc_pages(s, up)
        return True

    def _admit(self, out: list) -> bool:
        """The admission half of ``_plan_dispatch``: swap-ins first, then
        in-block admissions into empty slots of a running pool, then
        batched (or chunked) prefill.  Returns whether in-block refill is
        in use for the coming block."""
        t_plan = time.perf_counter()
        if (self.schedule == "longest_first" and self._queue_dirty
                and len(self.queue) > 1):
            # once per batch of submissions; requeued refills re-enter at
            # the front they were popped from
            self.queue = deque(sorted(self.queue, key=lambda r: -r.max_new))
        self._queue_dirty = False
        if self.paged and self.swapped:
            self._resume_swapped()  # preempted requests take priority
        live_any = any(o is not None for o in self.occupant)
        use_inblock = self.inblock_refill and live_any
        if use_inblock and not self._hold_for_resume():
            for slot in range(self.slots):
                if (self.occupant[slot] is not None
                        or slot in self.admitting or not self.queue):
                    continue
                if len(self.queue[0].prompt) > self.inblock_admit_limit:
                    break  # strict FIFO: a long head admits batched below
                if self.prefix_cache and self._prefix_lookup(self.queue[0]):
                    break  # a cached prefix admits over the shared pages
                req = self.queue.popleft()
                if not self._occupy_prefilling(slot, req):
                    self.queue.appendleft(req)  # page pool full: wait
                    break
        self.timers.add("host_plan", time.perf_counter() - t_plan)
        with self.timers.phase("prefill"):
            if self.prefill_chunk is None:
                if not use_inblock or (
                        self.queue and len(self.queue[0].prompt)
                        > self.inblock_admit_limit):
                    out += self._fill_free_slots()
            else:
                out += self._advance_admissions()
        return use_inblock

    def _plan_dispatch(self, out: list) -> _InFlight | None:
        """Admit queued work from the CURRENT (fully parsed) host state,
        stage the pool, and dispatch one decode block without parsing its
        results (``_collect`` does: the serial path at once, the
        overlapped path on the next ``step()``).  Speculative blocks
        dispatch AND parse here.  Returns None when nothing is live after
        admission."""
        use_inblock = self._admit(out)
        t_plan = time.perf_counter()
        live = [s for s in range(self.slots) if self.occupant[s] is not None]
        if not live:
            self.timers.add("host_plan", time.perf_counter() - t_plan)
            return None
        # per-slot staging: remaining budgets drive the early exit (empty
        # slots: 0); mid-prefill occupants carry prompt + offset
        budget = np.zeros(self.slots, np.int32)
        plen = np.zeros(self.slots, np.int32)
        poff = np.zeros(self.slots, np.int32)
        prompt = np.zeros((self.slots, self.refill_width), np.int32)
        pos = self.pos.copy()
        for s in live:
            occ = self.occupant[s]
            budget[s] = occ.max_new - len(occ.emitted)
            if self.slot_poff[s] < len(occ.prompt):
                plen[s] = len(occ.prompt)
                poff[s] = self.slot_poff[s]
                prompt[s, :plen[s]] = occ.prompt
                pos[s] = poff[s]  # next write = next prompt position
            else:
                pos[s] = min(pos[s] + 1, self.max_len - 1)  # next write
        upto = np.zeros(self.slots, np.int32)
        if self.paged:
            # pages covering this block's write frontier: a slot that
            # retires early clamps at its frontier; under pool pressure
            # the youngest occupant is preempted
            for s in list(live):
                if self.occupant[s] is None:
                    continue  # evicted as an earlier slot's victim
                pr = int(plen[s]) - int(poff[s]) if plen[s] else 0
                writes = self._block_writes(pr, int(budget[s]))
                upto[s] = min(int(pos[s]) + writes - 1, self.kv_len - 1)
                self._ensure_pages_or_evict(s, int(upto[s]))
            for s in list(live):
                if self.occupant[s] is None:  # evicted: out of the block
                    live.remove(s)
                    budget[s] = 0
                    plen[s] = 0
            if not live:
                self.timers.add("host_plan", time.perf_counter() - t_plan)
                return None
        if use_inblock:
            self._stage_refills()
        # prompt-left + budget at dispatch: _try_chain's bound on whether
        # this block (or its chained successor) could retire the slot
        headroom = np.zeros(self.slots, np.int32)
        for s in live:
            pr = int(plen[s]) - int(poff[s]) if plen[s] else 0
            headroom[s] = pr + int(budget[s])
        table = (self.table if self.paged
                 else np.zeros((self.slots, 1), np.int32))
        caps = self._write_caps()
        if self.n_spec:
            # speculative staging: each live slot's stream (known tokens at
            # their positions), determined count and cache frontier
            stream = np.zeros((self.slots, self.kv_len), np.int32)
            det = np.zeros(self.slots, np.int32)
            wr = np.zeros(self.slots, np.int32)
            for s in live:
                occ = self.occupant[s]
                lp = len(occ.prompt)
                stream[s, :lp] = occ.prompt
                ne = len(occ.emitted)
                if ne:
                    stream[s, lp:lp + ne] = np.asarray(occ.emitted, np.int32)
                det[s] = lp + ne
                wr[s] = (self.slot_poff[s] if self.slot_poff[s] < lp
                         else self.pos[s] + 1)
        # drained-tail compaction (paged): with no queued or staged work
        # left and few slots live, a block over just the live slots' rows
        compact = (self.compact_tail and self.paged and not self.queue
                   and not self.admitting and not self.swapped
                   and all(r is None for r in self.staged_refill)
                   and len(live) <= self.slots // 2)
        sampled = any(self.occupant[s].temperature > 0 for s in live) or \
            any(r is not None and r.temperature > 0
                for r in self.staged_refill)
        if compact:
            w = 1 << max(len(live) - 1, 0).bit_length()
            sel = np.asarray(live + [live[0]] * (w - len(live)))
            npad = w - len(live)

            def cut(a):
                return np.asarray(a)[sel].copy()

            budget_c, caps_c, table_c = cut(budget), cut(caps), cut(table)
            pos_c, plen_c, poff_c = cut(pos), cut(plen), cut(poff)
            if npad:
                # pad rows are dead: zero budget (done at step 0), zero
                # plen, their clamped writes on the scratch page
                for a in (budget_c, caps_c, table_c, pos_c, plen_c, poff_c):
                    a[-npad:] = 0
            cur = dict(plen=plen_c, temp=cut(self.slot_temp),
                       top_k=cut(self.slot_topk), top_p=cut(self.slot_topp),
                       eos=cut(self.slot_eos), cap=caps_c, table=table_c)
            carry = None
            if self.n_spec:
                det_c, wr_c = cut(det), cut(wr)
                if npad:
                    det_c[-npad:] = 1  # pad rows: rem 0, done at round 0
                    wr_c[-npad:] = 0
                cur.update(stream=cut(stream), det=det_c, wr=wr_c,
                           rem=budget_c)
            else:
                cur.update(prompt=cut(prompt))
                carry = dict(tok=cut(self.last_tok), pos=pos_c, poff=poff_c,
                             rem=budget_c, done=np.zeros(w, bool),
                             active=np.zeros(w, bool), lw=pos_c.copy())
            ref = dict(valid=np.zeros(w, bool), plen=np.zeros(w, np.int32),
                       prompt=np.zeros((w, self.refill_width), np.int32),
                       temp=np.ones(w, np.float32),
                       top_k=np.zeros(w, np.int32),
                       top_p=np.ones(w, np.float32),
                       eos=np.full(w, -1, np.int32),
                       budget=np.zeros(w, np.int32),
                       cap=np.zeros(w, np.int32),
                       table=np.zeros_like(table_c))
            cols = {s: j for j, s in enumerate(live)}
            self.stats["compact_dispatches"] += 1
        else:
            w, npad = self.slots, 0
            r_valid = np.zeros(w, bool)
            r_plen = np.zeros(w, np.int32)
            r_prompt = np.zeros((w, self.refill_width), np.int32)
            r_temp = np.ones(w, np.float32)
            r_topk = np.zeros(w, np.int32)
            r_topp = np.ones(w, np.float32)
            r_eos = np.full(w, -1, np.int32)
            r_budget = np.zeros(w, np.int32)
            for s, req in enumerate(self.staged_refill):
                if req is None:
                    continue
                r_valid[s] = True
                r_plen[s] = len(req.prompt)
                r_prompt[s, :r_plen[s]] = req.prompt
                (r_temp[s], r_topk[s], r_topp[s], r_eos[s],
                 r_budget[s]) = self._req_fields(req)
            if self.paged:
                r_cap = self._write_caps(self.refill_pages)
                r_table = self.r_table
            else:
                r_cap = np.full(w, self.kv_len - 1, np.int32)
                r_table = np.zeros((w, 1), np.int32)
            cur = dict(plen=plen, temp=self.slot_temp, top_k=self.slot_topk,
                       top_p=self.slot_topp, eos=self.slot_eos, cap=caps,
                       table=table)
            carry = None
            if self.n_spec:
                cur.update(stream=stream, det=det, wr=wr, rem=budget)
            else:
                cur.update(prompt=prompt)
                carry = dict(tok=self.last_tok, pos=pos, poff=poff,
                             rem=budget, done=np.zeros(w, bool),
                             active=np.zeros(w, bool), lw=pos.copy())
            ref = dict(valid=r_valid, plen=r_plen, prompt=r_prompt,
                       temp=r_temp, top_k=r_topk, top_p=r_topp, eos=r_eos,
                       budget=r_budget, cap=r_cap, table=r_table)
            cols = {s: s for s in live}
        # _dev copies: the host mirrors change while a block is in flight
        cur = {k_: self._dev(v) for k_, v in cur.items()}
        ref = {k_: self._dev(v) for k_, v in ref.items()}
        self.timers.add("host_plan", time.perf_counter() - t_plan)
        if self.n_spec:
            gcols = 0
            if self.paged:
                # deepest allocated frontier across the rows (occupants and
                # staged refills), rounded up to a power of two
                deep = max([len(self.slot_pages[s]) for s in live]
                           + [len(self.refill_pages[s])
                              for s in range(self.slots)
                              if self.staged_refill[s] is not None]
                           + [1])
                gcols = min(1 << (deep - 1).bit_length(),
                            self.pages_per_slot)
            with self.timers.phase("dispatch"):
                flat, n_exec = self._decode_spec_block(cur, ref, w, gcols,
                                                       sampled)
            with self.timers.phase("host_parse"):
                self._parse_spec_block(flat, n_exec, live, cols, w, out)
            return None
        with self.timers.phase("dispatch"):
            carry = {k_: self._dev(v) for k_, v in carry.items()}
            packed, carry, k_exec = self._decode_block(cur, ref, carry, w,
                                                       sampled)
        return _InFlight(
            packed=packed, k_exec=k_exec, carry=carry, cur=cur, ref=ref,
            sampled=sampled, live=live, cols=cols, w=w, compact=compact,
            npad=npad, plen=plen, active0=np.zeros(self.slots, bool),
            headroom=headroom, upto=upto, chainable=not compact)

    def _collect(self, fl: _InFlight) -> list[tuple[int, int]]:
        """Wait for an in-flight block's packed results (one device->host
        transfer, behind its own event: a chained successor keeps
        computing) and mirror them on the host: emissions, retire / refill
        handoffs, frontier sync, prefix publication, accounting.  With
        ``refs_held`` (a chained successor uses the staged refills),
        unused refills stay staged instead of requeueing."""
        out: list[tuple[int, int]] = []
        k, w, live, cols = self.steps_per_sync, fl.w, fl.live, fl.cols
        plen, k_exec = fl.plen, fl.k_exec
        with self.timers.phase("fetch"):
            flat = self._finish_fetch(fl.packed)
        t0 = time.perf_counter()
        occ_before = [self.occupant[s] for s in live]
        kn = k * w
        toks = flat[:kn].reshape(k, w)  # rows >= k_exec unused
        mask = flat[kn:2 * kn].reshape(k, w).astype(bool)
        sw = flat[2 * kn:2 * kn + w]
        lw = flat[2 * kn + w:2 * kn + 2 * w]
        poff_f = flat[2 * kn + 2 * w:2 * kn + 3 * w]
        pf = flat[2 * kn + 3 * w:2 * kn + 4 * w]
        if fl.compact and fl.npad:
            pf = pf[:len(live)]  # pad rows: plen zeroed, no prefill
        self.stats["decode_dispatches"] += 1
        self.stats["slot_steps"] += k_exec * w
        self.stats["inblock_prefill_steps"] += int(np.sum(pf))
        emitted_before = self.stats["emitted_tokens"]
        for s in live:
            j = cols[s]
            cut = min(int(sw[j]), k_exec)
            for i in range(cut):
                if mask[i, j] and self.occupant[s] is not None:
                    self._emit(s, int(toks[i, j]), out)
            if self.occupant[s] is not None:
                # the request continues; carry prefill progress for slots
                # staged mid-prefill, or switched in an earlier chained
                # block (active0: the device's poff then tracks the refill)
                if plen[s] or fl.active0[s]:
                    self.slot_poff[s] = int(poff_f[j])
                self.pos[s] = int(lw[j])
                self._maybe_publish_prompt_pages(s)
            elif int(sw[j]) <= k_exec:
                # the device switched this slot to its staged refill
                req = self.staged_refill[s]
                self.staged_refill[s] = None
                self._staged_order.remove(s)
                self._install_refill(s, req)
                self.stats["inblock_refills"] += 1
                for i in range(int(sw[j]), k_exec):
                    if mask[i, j] and self.occupant[s] is not None:
                        self._emit(s, int(toks[i, j]), out)
                if self.occupant[s] is not None:
                    self.slot_poff[s] = int(poff_f[j])
                    self.pos[s] = int(lw[j])
                    self._maybe_publish_prompt_pages(s)
        if not fl.refs_held:
            self._requeue_unused_refills()
        # any occupancy change makes a chained successor's scheduling
        # metadata stale: break the chain after it (step())
        for idx, s in enumerate(live):
            if self.occupant[s] is not occ_before[idx]:
                self._break_chain = True
        self.stats["wasted_slot_steps"] += (
            k_exec * w - (self.stats["emitted_tokens"] - emitted_before)
            - int(np.sum(pf)))
        self.timers.add("host_parse", time.perf_counter() - t0)
        return out

    def _sync_spec_slot(self, s: int, wr: int) -> None:
        """Mirror a continuing slot's device frontier after a speculative
        block: ``wr`` is the cache frontier, so the last written position
        is wr-1 and prompt progress is min(wr, plen)."""
        occ = self.occupant[s]
        self.slot_poff[s] = min(wr, len(occ.prompt))
        self.pos[s] = wr - 1
        if occ.emitted:
            self.last_tok[s] = occ.emitted[-1]
        self._maybe_publish_prompt_pages(s)

    def _parse_spec_block(self, flat, n_exec: int, live, cols, w: int,
                          out) -> None:
        """Mirror a speculative block's results on the host: per-round
        emission chunks (device-truncated at eos/budget, re-checked by
        ``_emit``), the retire -> refill handoff at round granularity,
        frontier sync, and the speculation accounting."""
        r_max, wk = self.steps_per_sync, self.n_spec + 1
        n = r_max * w * wk
        etok = flat[:n].reshape(r_max, w, wk)
        ecnt = flat[n:n + r_max * w].reshape(r_max, w)
        off = n + r_max * w
        sw = flat[off:off + w]
        wrf = flat[off + w:off + 2 * w]
        pf = flat[off + 2 * w:off + 3 * w]
        prop_n, prop_acc = int(flat[-2]), int(flat[-1])
        self.stats["decode_dispatches"] += 1
        self.stats["slot_steps"] += n_exec * w * wk
        self.stats["spec_rounds"] += n_exec
        self.stats["spec_proposed"] += prop_n
        self.stats["spec_accepted"] += prop_acc
        self.stats["inblock_prefill_steps"] += int(np.sum(pf))
        emitted_before = self.stats["emitted_tokens"]

        def emit_rounds(s, j, lo, hi):
            for r in range(lo, hi):
                for t in range(int(ecnt[r, j])):
                    if self.occupant[s] is None:
                        return
                    self._emit(s, int(etok[r, j, t]), out)

        for s in live:
            j = cols[s]
            emit_rounds(s, j, 0, min(int(sw[j]), n_exec))
            if self.occupant[s] is not None:
                self._sync_spec_slot(s, int(wrf[j]))
            elif int(sw[j]) <= n_exec:
                # the device switched this slot to its staged refill
                req = self.staged_refill[s]
                self.staged_refill[s] = None
                self._staged_order.remove(s)
                self._install_refill(s, req)
                self.stats["inblock_refills"] += 1
                emit_rounds(s, j, int(sw[j]), n_exec)
                if self.occupant[s] is not None:
                    self._sync_spec_slot(s, int(wrf[j]))
        self._requeue_unused_refills()
        self.stats["wasted_slot_steps"] += (
            n_exec * w * wk - (self.stats["emitted_tokens"] - emitted_before)
            - int(np.sum(pf)))

    def run(self, prompts, max_new: int = 128) -> dict[int, np.ndarray]:
        """Submit every prompt, drive to completion, return rid -> tokens."""
        rids = [self.submit(p, max_new) for p in prompts]
        while self.pending():
            self.step()
        return {rid: self.result(rid) for rid in rids}
