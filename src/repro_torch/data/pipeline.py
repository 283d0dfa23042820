"""In-memory data pipeline — the paper's "large in-memory dataset" tier (§4.5)
(``repro/data/pipeline.py``).

  * :class:`InMemoryDataset` — the full token array lives in host memory,
    sharded by data-parallel rank (each rank owns a contiguous shard, like
    each HMC owning its sample range).
  * :class:`DataIterator` — stateless-resumable: batch t is a pure function
    of (seed, t), so checkpoint/restart reproduces the exact same sample
    stream (:mod:`repro_torch.runtime.supervisor` relies on this).
  * :class:`Prefetcher` — a daemon thread that keeps ``depth`` batches
    ready on ``device``, the cluster-DMA pattern applied at the input layer.

Tokens and batches are numpy arrays drawn by numpy's ``RandomState`` as in
the JAX package, so both packages see the same bits.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class InMemoryDataset:
    tokens: np.ndarray  # (n_tokens,) int32 — resident, canonical, dense
    seq_len: int
    vocab_size: int

    @classmethod
    def synthetic(cls, n_tokens: int, vocab_size: int, seq_len: int, seed: int = 0):
        """Deterministic synthetic corpus with local structure (ngram-ish),
        so cross-entropy actually decreases during training."""
        rng = np.random.RandomState(seed)
        # Markov-ish stream: next token = f(prev) + noise, so it is learnable.
        n = int(n_tokens)
        base = rng.randint(0, vocab_size, size=n // 16 + 2).astype(np.int64)
        idx = np.arange(n)
        toks = (base[idx // 16] * 31 + idx % 16 * 7) % vocab_size
        noise = rng.rand(n) < 0.1
        toks[noise] = rng.randint(0, vocab_size, noise.sum())
        return cls(tokens=toks.astype(np.int32), seq_len=seq_len, vocab_size=vocab_size)

    @classmethod
    def from_arrays(cls, tokens: np.ndarray, seq_len: int, vocab_size: int):
        return cls(tokens=np.asarray(tokens, np.int32), seq_len=seq_len, vocab_size=vocab_size)

    @property
    def n_sequences(self) -> int:
        return (len(self.tokens) - 1) // self.seq_len

    def shard(self, rank: int, world: int) -> "InMemoryDataset":
        """Contiguous per-rank shard (each HMC holds its own sample range)."""
        per = self.n_sequences // world
        lo = rank * per * self.seq_len
        hi = (rank + 1) * per * self.seq_len + 1
        return InMemoryDataset(self.tokens[lo:hi], self.seq_len, self.vocab_size)

    def batch_at(self, step: int, batch_size: int, seed: int = 0) -> dict:
        """Pure function of (seed, step): the resumability contract."""
        n = self.n_sequences
        # counter RNG keyed by (seed, step) — no mutable state
        rng = np.random.RandomState((seed * 1_000_003 + step) % (2**31))
        idx = rng.randint(0, n, size=batch_size)
        starts = idx * self.seq_len
        offs = np.arange(self.seq_len + 1)
        seqs = self.tokens[starts[:, None] + offs[None, :]]  # (B, S+1)
        return {"inputs": seqs[:, :-1], "labels": seqs[:, 1:]}


class DataIterator:
    """Checkpointable iterator: state == (seed, step). Nothing else."""

    def __init__(self, dataset: InMemoryDataset, batch_size: int, seed: int = 0, step: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.step = step

    def __next__(self) -> dict:
        batch = self.dataset.batch_at(self.step, self.batch_size, self.seed)
        self.step += 1
        return batch

    def state_dict(self) -> dict:
        return {"seed": self.seed, "step": self.step, "batch_size": self.batch_size}

    def load_state_dict(self, state: dict):
        self.seed = int(state["seed"])
        self.step = int(state["step"])


class Prefetcher:
    """Double-buffered host->device prefetch (the input-layer DMA).

    A daemon thread draws batches from ``iterator`` and puts them, as
    tensors on ``device`` (the CPU when None), into a queue of ``depth``.
    :meth:`stop` ends the thread and joins it within ``timeout`` seconds.
    """

    def __init__(self, iterator: DataIterator, depth: int = 2, device=None):
        self.iterator = iterator
        self.device = torch.device("cpu") if device is None else torch.device(device)
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _worker(self):
        while not self._stop.is_set():
            batch = {k: torch.as_tensor(v).to(self.device) for k, v in next(self.iterator).items()}
            while not self._stop.is_set():
                try:
                    self.q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __next__(self):
        return self.q.get()

    def stop(self, timeout: float = 2.0) -> bool:
        """Stop the worker; True once it has ended within ``timeout`` seconds."""
        self._stop.set()
        # drain so the worker can exit
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.thread.join(timeout=timeout)
        return not self.thread.is_alive()
