"""LM training data pipeline: document stream -> dedup -> packed batches.

The port of the JAX package's `repro.data.pipeline`.  Each data-parallel
host materialises only its slice of the global batch (`host_index` of
`n_hosts`), documents flow through an optional Cabin/Cham near-duplicate
filter (repro_torch.data.dedup, on the pipeline's `device`: the kernels on
a card, their plain versions on the CPU) before packing, and batches are
yielded as host numpy arrays.  Double-buffered prefetch via a background
thread.

The synthetic corpus is a seeded Markov-ish byte source — deterministic
across restarts (checkpoint/resume replays the stream position, so training
is bitwise reproducible after failover).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterable, Iterator

import numpy as np

from repro_torch.data import dedup as dedup_mod
from repro_torch.data import tokenizer
from repro_torch.device import resolve_device


@dataclass(frozen=True)
class PipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    dedup: bool = False
    dedup_sketch_dim: int = 1024
    dedup_threshold: float = 8.0
    dedup_window: int = 512  # docs per dedup block
    n_hosts: int = 1
    host_index: int = 0
    prefetch: int = 2


def synthetic_documents(
    vocab_size: int, seed: int, mean_len: int = 512,
    dup_fraction: float = 0.0,
) -> Iterator[np.ndarray]:
    """Infinite stream of synthetic token documents (Zipfian unigram with
    per-doc topic bias; optionally emits near-duplicates for dedup tests)."""
    rng = np.random.default_rng(seed)
    base = 1.0 / np.arange(1, vocab_size - 2) ** 1.05
    last: np.ndarray | None = None
    while True:
        if last is not None and rng.random() < dup_fraction:
            doc = last.copy()
            n_edit = max(1, int(0.02 * len(doc)))
            pos = rng.integers(0, len(doc), size=n_edit)
            doc[pos] = rng.integers(3, vocab_size, size=n_edit)
            yield doc
            continue
        topic = rng.integers(0, 16)
        w = base.copy()
        lo = (topic * 977) % (vocab_size - 3)
        w[lo : lo + 500] *= 8.0
        w /= w.sum()
        n = max(8, int(rng.normal(mean_len, mean_len * 0.25)))
        body = rng.choice(vocab_size - 3, size=n, p=w).astype(np.int32) + 3
        doc = np.concatenate([[tokenizer.BOS_ID], body, [tokenizer.EOS_ID]]
                             ).astype(np.int32)
        last = doc
        yield doc


def document_windows(
    docs: Iterable[np.ndarray], window: int
) -> Iterator[list[np.ndarray]]:
    """Group a document stream into fixed-size windows.

    The unit of work for every streaming sketch consumer: the dedup stage
    below sketches one window at a time, and repro_torch.index.ingest feeds
    windows into a live QueryEngine.  A finite stream yields its last,
    possibly short, window; an infinite stream yields forever.  Accepts any
    iterable; a re-iterable (list) is consumed once, like an iterator.
    """
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    docs = iter(docs)
    while True:
        batch: list[np.ndarray] = []
        for doc in docs:
            batch.append(doc)
            if len(batch) == window:
                break
        if not batch:
            return
        yield batch
        if len(batch) < window:  # stream exhausted mid-window
            return


def _pack_documents(
    docs: Iterator[np.ndarray], seq_len: int
) -> Iterator[np.ndarray]:
    """Greedy sequence packing: concatenate docs, emit seq_len+1 windows."""
    buf = np.zeros(0, dtype=np.int32)
    need = seq_len + 1
    while True:
        while len(buf) < need:
            buf = np.concatenate([buf, next(docs)])
        yield buf[:need].copy()
        buf = buf[seq_len:]


class BatchPipeline:
    """Iterator of {'tokens': (B_host, S), 'labels': (B_host, S)} batches.
    `device` runs the dedup stage ("cuda" by default; RuntimeError where
    CUDA is absent unless the caller passes "cpu"): the batches are the
    same bits on either."""

    def __init__(self, cfg: PipelineConfig, device="cuda"):
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.host_batch = cfg.global_batch // cfg.n_hosts
        self._steps = 0
        docs = synthetic_documents(cfg.vocab_size, cfg.seed * 1000 + cfg.host_index)
        if cfg.dedup:
            docs = self._dedup_stream(docs)
        self._windows = _pack_documents(docs, cfg.seq_len)
        self._queue: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    # -- dedup stage --------------------------------------------------------
    def _dedup_stream(self, docs: Iterator[np.ndarray]) -> Iterator[np.ndarray]:
        cfg = self.cfg
        for window in document_windows(docs, cfg.dedup_window):
            idx, val = dedup_mod.docs_to_categorical(window, cfg.vocab_size)
            _, sketches = dedup_mod.sketch_corpus(
                idx, val, cfg.vocab_size, cfg.dedup_sketch_dim, seed=cfg.seed,
                device=self.device)
            result = dedup_mod.dedup_by_sketch(
                sketches, cfg.dedup_sketch_dim, cfg.dedup_threshold,
                device=self.device)
            for doc, keep in zip(window, result.keep_mask):
                if keep:
                    yield doc

    # -- prefetch -----------------------------------------------------------
    def _producer(self) -> None:
        while not self._stop.is_set():
            batch = self._make_batch()
            try:
                self._queue.put(batch, timeout=60)
            except queue.Full:  # consumer gone
                if self._stop.is_set():
                    return

    def _make_batch(self) -> dict[str, np.ndarray]:
        rows = np.stack([next(self._windows) for _ in range(self.host_batch)])
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}

    def __iter__(self):
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        self._steps += 1
        return self._queue.get()

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
