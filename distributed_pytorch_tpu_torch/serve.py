"""Continuous batching: slot-based autoregressive serving, the core of the
JAX package's serve.py ContinuousBatcher.

A fixed pool of cache slots where sequences enter (bucketed batched prefill
into a free slot), decode in lockstep (one ragged decode step per token for
every slot) and retire independently (EOS or length budget), their slot
refilled from the queue at the next block boundary:

- the slot pool is one contiguous (slots, Hkv, max_len, Dh) KV cache per
  layer; prompts pad to bucketed lengths;
- per-sequence exactness comes from the ragged decode step
  (generate.decode_step_ragged): every sequence reads exactly its own
  ``pos+1`` cache prefix (the decode kernel's per-sequence bound on the
  GPU) and writes its K/V at its own offset;
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
  ``submit()`` parameters, applied per slot by ``sample_per_seq``.

Differences from the JAX batcher: ``inblock_refill`` and ``overlap``
default to False and passing True raises for now.  Both change only the
scheduling (when a retired slot refills, when a block's results are
fetched), never the tokens, so greedy outputs are the same.  The paged pool
(and its ``compact_tail``), prefix caching, speculation (and its
``spec_ngram``), chunked prefill, tensor parallelism (``mesh``,
``tp_axis``) and the fleet handoff (``export_request``/``import_request``)
raise ``NotImplementedError`` naming the ROADMAP.md slice that brings them
whenever they are set to anything but their default.
"""

from __future__ import annotations

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

SERVING_SLICE = "ROADMAP.md queue 1, slice 3 (paged serving)"
FLEET_SLICE = "ROADMAP.md queue 1, slice 5 (fleet)"


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
    t_submit: float = 0.0
    t_first: float | None = None  # first emission (TTFT = t_first - t_submit)
    t_done: float | None = None


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
    there.
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
        refused = {"paged=True": paged, "pool_pages": pool_pages is not None,
                   "prefix_cache": prefix_cache,
                   "speculate > 0": speculate > 0,
                   "prefill_chunk": prefill_chunk is not None,
                   "inblock_refill=True": inblock_refill,
                   "overlap=True": overlap,
                   "compact_tail=False": not compact_tail,
                   "spec_ngram != 2": spec_ngram != 2}
        for what, on in refused.items():
            if on:
                raise not_ported(what, SERVING_SLICE)
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
        self.cache = gen.init_cache(cfg, slots, self.max_len,
                                    dtype=dtype or torch.float32,
                                    kv_heads=self.kv_heads,
                                    kv_dtype=self.kv_dtype,
                                    device=self.device)
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
        # accounting: slot-steps dispatched vs tokens delivered
        self.stats = {"decode_dispatches": 0, "decode_steps": 0,
                      "slot_steps": 0, "emitted_tokens": 0,
                      "wasted_slot_steps": 0, "prefill_dispatches": 0,
                      "batch_admissions": 0}

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
        self.requests[rid] = req
        self.queue.append(req)
        self._queue_dirty = True
        return rid

    def pending(self) -> bool:
        return bool(self.queue) or any(o is not None for o in self.occupant)

    def queue_depth(self) -> int:
        """Requests accepted but not yet generating."""
        return len(self.queue)

    def timing_stats(self) -> dict:
        """Per-phase wall-clock summary over every ``step()`` so far:
        ``host_plan`` (admission and staging), ``prefill`` (admission
        prefills), ``dispatch`` (the decode block's steps, including the
        per-step early-exit check), ``fetch`` (the block's device->host
        transfer), ``host_parse`` (emission bookkeeping)."""
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

    def _sample_first(self, req: _Request, last_logits) -> int:
        """Sample a freshly-admitted request's first token with ITS
        sampling parameters."""
        dev = self.device
        return int(gen.sample_per_seq(
            self.generator, last_logits[None],
            torch.full((1,), req.temperature, device=dev),
            torch.full((1,), req.top_k, dtype=torch.int32, device=dev),
            torch.full((1,), req.top_p, device=dev))[0])

    def _occupy(self, slot: int, req: _Request, first_tok: int,
                out: list) -> None:
        """Install a prefilled request into its slot and emit token 0."""
        self.occupant[slot] = req
        self.pos[slot] = len(req.prompt) - 1
        self.slot_temp[slot] = req.temperature
        self.slot_topk[slot] = req.top_k
        self.slot_topp[slot] = req.top_p
        self.slot_eos[slot] = -1 if req.eos_id is None else req.eos_id
        self.stats["batch_admissions"] += 1
        self._emit(slot, first_tok, out)

    def _fill_free_slots(self) -> list[tuple[int, int]]:
        """Prefill queued requests into free slots, one bucketed prefill
        each; returns the (rid, first token) pairs."""
        out: list[tuple[int, int]] = []
        for slot in range(self.slots):
            if self.occupant[slot] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            last_logits, slab = self._prefill(req.prompt)
            self.stats["prefill_dispatches"] += 1
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
        else:
            self.last_tok[slot] = tok

    # -- the decode block -------------------------------------------------
    def _decode_block(self, budget: np.ndarray, pos: np.ndarray):
        """Run up to ``steps_per_sync`` lockstep ragged decode steps for
        the whole pool.  Per-slot state stays on the device; the loop
        checks once per step whether every slot is done.  Returns device
        tensors (tokens (K, slots), emit mask (K, slots), last written
        position per slot) and the number of steps executed."""
        dev, k_steps, n = self.device, self.steps_per_sync, self.slots
        tok = torch.from_numpy(self.last_tok.astype(np.int64)).to(dev)
        pos_d = torch.from_numpy(pos).to(dev)
        rem = torch.from_numpy(budget).to(dev)
        temp = torch.from_numpy(self.slot_temp).to(dev)
        topk = torch.from_numpy(self.slot_topk).to(dev)
        topp = torch.from_numpy(self.slot_topp).to(dev)
        eos = torch.from_numpy(self.slot_eos).to(dev)
        cap = self.max_len - 1
        done = rem <= 0  # empty slots enter done
        lw = pos_d.clone()
        buf = torch.zeros((k_steps, n), dtype=torch.int32, device=dev)
        mask = torch.zeros((k_steps, n), dtype=torch.bool, device=dev)
        steps = 0
        while steps < k_steps and not bool(done.all()):
            logits, _ = gen.decode_step_ragged(
                self.params, self.cache, tok, pos_d, cfg=self.cfg,
                dtype=self.dtype, use_decode_kernel=self.use_kernel)
            toks = gen.sample_per_seq(self.generator, logits, temp, topk,
                                      topp)
            emit = ~done
            buf[steps] = toks
            mask[steps] = emit
            rem = rem - emit.to(rem.dtype)
            fin = emit & (((toks == eos) & (eos >= 0)) | (rem <= 0))
            lw = torch.where(emit, pos_d, lw)
            done = done | fin
            pos_d = torch.clamp(pos_d + 1, max=cap)
            tok = toks.long()
            steps += 1
        return buf, mask, lw, steps

    def step(self) -> list[tuple[int, int]]:
        """Admit queued work into free slots (batched prefill), then run
        one decode block for the whole pool.  Returns the (rid, token)
        pairs emitted this call, in per-slot sampling order."""
        out: list[tuple[int, int]] = []
        t_plan = time.perf_counter()
        if (self.schedule == "longest_first" and self._queue_dirty
                and len(self.queue) > 1):
            self.queue = deque(sorted(self.queue, key=lambda r: -r.max_new))
        self._queue_dirty = False
        self.timers.add("host_plan", time.perf_counter() - t_plan)
        with self.timers.phase("prefill"):
            out += self._fill_free_slots()
        t_plan = time.perf_counter()
        live = [s for s in range(self.slots) if self.occupant[s] is not None]
        if not live:
            self.timers.add("host_plan", time.perf_counter() - t_plan)
            return out
        budget = np.zeros(self.slots, np.int32)
        pos = self.pos.copy()
        for s in live:
            occ = self.occupant[s]
            budget[s] = occ.max_new - len(occ.emitted)
            pos[s] = min(pos[s] + 1, self.max_len - 1)  # next write
        self.timers.add("host_plan", time.perf_counter() - t_plan)
        with self.timers.phase("dispatch"):
            buf, mask, lw, steps = self._decode_block(budget, pos)
        with self.timers.phase("fetch"):
            # one device->host transfer for the whole block
            host = torch.cat([buf.reshape(-1),
                              mask.to(torch.int32).reshape(-1),
                              lw]).cpu().numpy()
        kn = self.steps_per_sync * self.slots
        toks = host[:kn].reshape(self.steps_per_sync, self.slots)
        mask = host[kn:2 * kn].reshape(self.steps_per_sync,
                                       self.slots).astype(bool)
        lw = host[2 * kn:]
        with self.timers.phase("host_parse"):
            emitted_before = self.stats["emitted_tokens"]
            for s in live:
                for i in range(steps):
                    if mask[i, s] and self.occupant[s] is not None:
                        self._emit(s, int(toks[i, s]), out)
                if self.occupant[s] is not None:
                    self.pos[s] = int(lw[s])
            self.stats["decode_dispatches"] += 1
            self.stats["decode_steps"] += steps
            self.stats["slot_steps"] += steps * self.slots
            self.stats["wasted_slot_steps"] += (
                steps * self.slots
                - (self.stats["emitted_tokens"] - emitted_before))
        return out

    def run(self, prompts, max_new: int = 128) -> dict[int, np.ndarray]:
        """Submit every prompt, drive to completion, return rid -> tokens."""
        rids = [self.submit(p, max_new) for p in prompts]
        while self.pending():
            self.step()
        return {rid: self.result(rid) for rid in rids}
