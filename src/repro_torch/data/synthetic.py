"""Synthetic LM data pipeline (the port's copy of
``repro.data.synthetic``; numpy only, bit-equal for the same seeds).

A deterministic, seekable token stream (Zipf-distributed unigrams mixed
with short learnable n-gram motifs so loss actually falls during the
example training runs), plus a host-side prefetching iterator that
mirrors a production input pipeline: the generator thread produces numpy
batches while the device works on the previous step.

``make_lm_batch`` is the pure stateless entry used by tests and the
dry-run; ``SyntheticLM`` is the stateful prefetching pipeline used by the
training loop (checkpointable via its ``state`` property).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


def _motif_table(vocab: int, n_motifs: int, motif_len: int,
                 seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(n_motifs, motif_len), dtype=np.int32)


def make_lm_batch(step: int, batch: int, seq_len: int, vocab: int,
                  seed: int = 0) -> Dict[str, np.ndarray]:
    """Deterministic batch for ``step`` (restart-safe: same step -> same
    batch). tokens[t+1] is the label for tokens[t]."""
    rng = np.random.default_rng((seed, step))
    # Zipf base stream (clipped to vocab)
    base = rng.zipf(1.3, size=(batch, seq_len + 1)).astype(np.int64)
    base = np.minimum(base - 1, vocab - 1).astype(np.int32)
    # overwrite random spans with motifs => predictable structure
    motifs = _motif_table(vocab, 64, 8, seed)
    n_spans = max(1, seq_len // 64)
    for b in range(batch):
        starts = rng.integers(0, seq_len - 8, size=n_spans)
        ids = rng.integers(0, len(motifs), size=n_spans)
        for s, mid in zip(starts, ids):
            base[b, s:s + 8] = motifs[mid]
    return {"tokens": base[:, :-1], "labels": base[:, 1:]}


class SyntheticLM:
    """Host-prefetching synthetic LM pipeline.

    Double-buffered: a daemon thread keeps ``prefetch`` batches ready.
    ``state``/``restore`` give step-accurate restart (fault tolerance).
    """

    def __init__(self, batch: int, seq_len: int, vocab: int, seed: int = 0,
                 prefetch: int = 2, start_step: int = 0):
        self.batch, self.seq_len, self.vocab = batch, seq_len, vocab
        self.seed = seed
        self._step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            b = make_lm_batch(step, self.batch, self.seq_len, self.vocab,
                              self.seed)
            while not self._stop.is_set():
                try:
                    self._q.put((step, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        step, b = self._q.get()
        self._step = step + 1
        return b

    @property
    def state(self) -> Dict[str, int]:
        return {"step": self._step, "seed": self.seed}

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    @staticmethod
    def restore(state: Dict[str, int], batch: int, seq_len: int,
                vocab: int, **kw) -> "SyntheticLM":
        return SyntheticLM(batch, seq_len, vocab, seed=state["seed"],
                           start_step=state["step"], **kw)
