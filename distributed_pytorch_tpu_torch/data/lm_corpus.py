"""Language-model data pipeline: byte-level corpus -> (tokens, targets) batches.

A numpy-only copy of the JAX package's data/lm_corpus.py (the port imports
nothing of that package): for the same seed and epoch it yields exactly the
same batches.

The LM-side sibling of the CIFAR pipeline (cifar10.py/pipeline.py): loads a
text corpus from disk (any file, byte-level vocabulary — no external
tokenizer dependency), or falls back to a deterministic synthetic corpus
(this image has no network egress).  Batching follows the standard LM
recipe: the corpus is one long token stream cut into fixed-length windows;
``targets[t] = tokens[t + 1]`` is precomputed host-side so sequence-parallel
shards never need their neighbor's tokens (lm.py's contract).

Sharding mirrors the reference's ``DistributedSampler(num_replicas, rank)``
(reference main_all_reduce.py:112): window order is a seeded global
permutation, windows are rank-strided, and the epoch is padded so every rank
sees the same number of windows.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops.nn import IGNORE_INDEX

VOCAB_SIZE = 256  # byte-level


# ---------------------------------------------------------------------------
# Corpus loading
# ---------------------------------------------------------------------------

_WORDS = (
    "the of to and in is it you that he was for on are with as his they be "
    "at one have this from or had by hot word but what some we can out other "
    "were all there when up use your how said an each she which do their "
    "time if will way about many then them write would like so these her "
    "long make thing see him two has look more day could go come did number "
    "sound no most people my over know water than call first who may down "
    "side been now find any new work part take get place made live where "
    "after back little only round man year came show every good me give our "
    "under name very through just form sentence great think say help low "
    "line differ turn cause much mean before move right boy old too same "
    "tell does set three want air well also play small end put home read "
    "hand port large spell add even land here must big high such follow act "
    "why ask men change went light kind off need house picture try us again "
    "animal point mother world near build self earth father").split()


def synthetic_corpus(n_bytes: int = 1 << 20, seed: int = 0) -> bytes:
    """Deterministic pseudo-English: a first-order Markov chain over a word
    list.  Structured enough that a byte LM's loss falls fast (spaces, word
    shapes, bigram statistics) yet fully reproducible with no data files."""
    rng = np.random.default_rng(seed)
    n_words = len(_WORDS)
    # Sparse, deterministic transition table: each word links to 8 successors.
    succ = rng.integers(0, n_words, (n_words, 8))
    out: list[str] = []
    total = 0
    w = 0
    sentence_len = 0
    while total < n_bytes:
        word = _WORDS[w]
        if sentence_len == 0:
            word = word.capitalize()
        out.append(word)
        total += len(word) + 1
        sentence_len += 1
        if sentence_len >= int(rng.integers(6, 16)):
            out[-1] += "."
            total += 1
            sentence_len = 0
        w = int(succ[w, int(rng.integers(0, 8))])
    return (" ".join(out)).encode("ascii")[:n_bytes]


def encode(text: bytes | str) -> np.ndarray:
    if isinstance(text, str):
        text = text.encode("utf-8")
    return np.frombuffer(text, dtype=np.uint8).astype(np.int32)


def decode(tokens: np.ndarray) -> str:
    return bytes(np.asarray(tokens, dtype=np.uint8)).decode(
        "utf-8", errors="replace")


@dataclass
class LMCorpus:
    """One long token stream: int32 in [0, 256), or a lazy uint8 memmap
    (``load_corpus(mmap=True)``) — the loader casts per batch either way."""

    tokens: np.ndarray
    synthetic: bool = False

    def __len__(self) -> int:
        return len(self.tokens)


def load_corpus(path: str | None = None, *,
                synthetic_bytes: int = 1 << 20,
                mmap: bool = False) -> LMCorpus:
    """Load a text file as a byte-level corpus, else the synthetic fallback.

    ``mmap=True`` memory-maps the file instead of reading it: the corpus
    never materializes in host RAM — each batch's windows are read lazily
    through the page cache, so a rank only ever touches its own shard's
    pages.  This is the ingestion path for corpora larger than one host's
    memory (every rank opens the same file; the per-rank window striding in
    ``LMDataLoader`` does the sharding).  Byte-level vocabulary means the
    on-disk bytes ARE the token stream — no detokenized copy exists.
    """
    if path is not None:
        if mmap:
            return LMCorpus(np.memmap(path, dtype=np.uint8, mode="r"),
                            synthetic=False)
        with open(path, "rb") as f:
            return LMCorpus(encode(f.read()), synthetic=False)
    if mmap:
        raise ValueError(
            "mmap=True requires a corpus path: the synthetic fallback is "
            "generated in RAM, which defeats the larger-than-memory intent")
    return LMCorpus(encode(synthetic_corpus(synthetic_bytes)), synthetic=True)


# ---------------------------------------------------------------------------
# Batched window iteration
# ---------------------------------------------------------------------------

class LMDataLoader:
    """Deterministic sharded (tokens, targets) batch iterator.

    Windows are contiguous ``seq_len`` slices at stride ``seq_len``; the
    target of the window's last position is the next byte of the stream
    (available because windows never start at the final token).  Epoch
    shuffling, rank striding, and padding reproduce DistributedSampler
    semantics (shuffle seed, ``num_replicas``/``rank``, cyclic padding).
    ``drop_last`` defaults to True: a partial final batch would change the
    compiled step's shapes (recompile) and break divisibility over the
    data-parallel mesh axis.

    ``shuffle_mode``: 'permutation' (default) materializes the exact
    DistributedSampler epoch permutation — O(n_windows) index memory.
    'affine' draws a full-period modular-affine bijection
    (idx = (a*x + b) mod n, gcd(a, n) = 1) per epoch instead: O(1) memory,
    for corpora whose window COUNT is itself too large to index in host
    RAM (pairs with ``load_corpus(mmap=True)``).  Weaker statistical
    shuffle (a strided walk), same determinism and sharding guarantees.

    ``elastic_order`` (round 12, the ``data.sampler.ElasticSampler``
    convention): the default rank assignment interleaves padded-order
    positions by rank (``p = j * num_replicas + rank``), so the GLOBAL
    consumption order depends on ``num_replicas`` — resume a checkpoint
    at a different world size and windows are silently dropped and
    double-consumed.  With ``elastic_order=True`` the epoch order is
    consumed in CONTIGUOUS global-batch blocks per step and rank ``r``
    takes the ``r``-th contiguous stripe: the global order is a pure
    function of (seed, epoch, step) — never the world size — so an
    elastic resize mid-run (the recorded (epoch, offset) replayed into
    a re-strided loader) loses and repeats nothing.  ``lm_cli
    --elastic`` sets it.
    """

    def __init__(
        self,
        corpus: LMCorpus,
        batch_size: int,
        seq_len: int,
        *,
        num_replicas: int = 1,
        rank: int = 0,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        shuffle_mode: str = "permutation",
        elastic_order: bool = False,
    ):
        if len(corpus) < seq_len + 1:
            raise ValueError(
                f"corpus of {len(corpus)} tokens is shorter than one "
                f"window ({seq_len} + 1)")
        if shuffle_mode not in ("permutation", "affine"):
            raise ValueError(f"shuffle_mode must be 'permutation' or "
                             f"'affine', got {shuffle_mode!r}")
        self.corpus = corpus
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.shuffle_mode = shuffle_mode
        self.elastic_order = elastic_order
        self._epoch = 0
        # -1: the last window must have a next-byte target available
        self.n_windows = (len(corpus) - 1) // seq_len
        self.per_rank = -(-self.n_windows // num_replicas)  # ceil -> padded

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        if self.drop_last:
            return self.per_rank // self.batch_size
        return -(-self.per_rank // self.batch_size)

    def _epoch_bijection(self):
        """This epoch's window bijection as a vectorized int->int map.

        Applied at padded-order position p as bijection(p % n_windows):
        identical to cycling the materialized permutation (the
        DistributedSampler convention — correct even when the pad exceeds
        n_windows)."""
        n = self.n_windows
        if not self.shuffle:
            return lambda x: x
        rng = np.random.default_rng(self.seed + self._epoch)
        if self.shuffle_mode == "permutation":
            perm = rng.permutation(n)
            return lambda x: perm[x]
        # affine: (a*x + b) mod n with gcd(a, n) == 1 is a bijection on
        # [0, n) — no index array ever materializes.  Python-int math per
        # element: a*x reaches (n-1)^2, which silently wraps int64 beyond
        # n ~ 3e9 windows — exactly this mode's target scale — and a
        # wrapped product breaks the bijection; batches are small, so the
        # arbitrary-precision loop is free.
        import math
        while True:
            a = int(rng.integers(1, max(n, 2)))
            if math.gcd(a, n) == 1:
                break
        b = int(rng.integers(0, max(n, 1)))
        if n < 2 or (n - 1) * (n - 1) + (n - 1) <= np.iinfo(np.int64).max:
            # common case: a*x + b <= (n-1)^2 + (n-1) fits int64 — vectorize
            return lambda x: (a * np.atleast_1d(np.asarray(x, np.int64))
                              + b) % n
        return lambda x: np.array([(a * int(v) + b) % n for v in np.atleast_1d(x)],
                                  dtype=np.int64)

    def __iter__(self):
        toks = self.corpus.tokens
        bij = self._epoch_bijection()
        end = (self.per_rank // self.batch_size * self.batch_size
               if self.drop_last else self.per_rank)
        for start in range(0, end, self.batch_size):
            js = np.arange(start, min(start + self.batch_size, end))
            if self.elastic_order:
                # world-size-independent global order (ElasticSampler
                # convention): step s consumes the contiguous block
                # [s*GB, (s+1)*GB) of the padded epoch order, rank r the
                # r-th contiguous stripe — a resize repartitions the
                # SAME stream instead of re-interleaving it
                step = start // self.batch_size
                p = (step * self.batch_size * self.num_replicas
                     + self.rank * self.batch_size + (js - start))
            else:
                p = js * self.num_replicas + self.rank
            idx = bij(p % max(self.n_windows, 1))
            batch = np.stack([
                toks[i * self.seq_len: i * self.seq_len + self.seq_len + 1]
                for i in idx])
            yield (batch[:, :-1].astype(np.int32),
                   batch[:, 1:].astype(np.int32))


def pad_targets_tail(targets: np.ndarray) -> np.ndarray:
    """Mask the final position of each row (for callers that assemble
    windows without a lookahead byte)."""
    out = targets.copy()
    out[:, -1] = IGNORE_INDEX
    return out
