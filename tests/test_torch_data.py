"""The port's in-memory data pipeline against the JAX package's (``repro.data``).

Both draw with numpy's ``RandomState``, so the synthetic corpus, every batch,
every shard and a resumed iterator's stream are equal bit for bit
(``np.array_equal``). The prefetcher's thread ends within its timeout.
"""

import time

import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro_torch.data import pipeline as pipe

CORPORA = [(50_000, 31, 8, 0), (20_003, 128, 32, 7), (2_000_000, 151_936, 64, 0)]


@pytest.mark.parametrize("n,vocab,seq,seed", CORPORA)
def test_synthetic_and_batches_equal_jax(n, vocab, seq, seed):
    got = pipe.InMemoryDataset.synthetic(n, vocab, seq, seed=seed)
    want = jpipe.InMemoryDataset.synthetic(n, vocab, seq, seed=seed)
    assert got.tokens.dtype == want.tokens.dtype == np.int32
    assert np.array_equal(got.tokens, want.tokens)
    assert got.n_sequences == want.n_sequences
    for step in (0, 1, 2, 999):
        for bs in (1, 4, 8):
            a, b = got.batch_at(step, bs, seed=3), want.batch_at(step, bs, seed=3)
            assert set(a) == set(b) == {"inputs", "labels"}
            for k in a:
                assert a[k].shape == b[k].shape == (bs, seq)
                assert np.array_equal(a[k], b[k])


def test_from_arrays_and_shards_equal_jax():
    toks = np.random.RandomState(0).randint(0, 97, 10_001)
    got = pipe.InMemoryDataset.from_arrays(toks, 10, 97)
    want = jpipe.InMemoryDataset.from_arrays(toks, 10, 97)
    assert np.array_equal(got.tokens, want.tokens) and got.tokens.dtype == np.int32
    for world in (1, 2, 3, 8):
        for rank in range(world):
            a, b = got.shard(rank, world), want.shard(rank, world)
            assert np.array_equal(a.tokens, b.tokens)
            assert (a.seq_len, a.vocab_size, a.n_sequences) == (b.seq_len, b.vocab_size,
                                                                 b.n_sequences)
            assert np.array_equal(a.batch_at(5, 4)["inputs"], b.batch_at(5, 4)["inputs"])


def test_iterator_resume_equals_jax():
    ds = pipe.InMemoryDataset.synthetic(50_000, 31, 8, seed=0)
    jds = jpipe.InMemoryDataset.synthetic(50_000, 31, 8, seed=0)
    it, jit_ = pipe.DataIterator(ds, 4, seed=1), jpipe.DataIterator(jds, 4, seed=1)
    for _ in range(5):
        a, b = next(it), next(jit_)
        assert np.array_equal(a["inputs"], b["inputs"])
    state = it.state_dict()
    assert state == jit_.state_dict() == {"seed": 1, "step": 5, "batch_size": 4}
    rest = [next(it)["labels"] for _ in range(3)]
    fresh = pipe.DataIterator(ds, 4)
    fresh.load_state_dict(state)
    jfresh = jpipe.DataIterator(jds, 4)
    jfresh.load_state_dict(state)
    for r in rest:
        a, b = next(fresh)["labels"], next(jfresh)["labels"]
        assert np.array_equal(a, r) and np.array_equal(a, b)
    assert fresh.state_dict() == jfresh.state_dict()


def test_prefetcher_yields_the_stream_as_tensors_and_stops_in_time():
    ds = pipe.InMemoryDataset.synthetic(50_000, 31, 8, seed=0)
    pf = pipe.Prefetcher(pipe.DataIterator(ds, 4, seed=2), depth=2, device="cpu")
    ref = pipe.DataIterator(ds, 4, seed=2)
    try:
        for _ in range(4):
            got, want = next(pf), next(ref)
            for k in ("inputs", "labels"):
                assert isinstance(got[k], torch.Tensor) and got[k].dtype == torch.int32
                assert np.array_equal(got[k].numpy(), want[k])
        assert pf.thread.daemon
    finally:
        t0 = time.perf_counter()
        stopped = pf.stop(timeout=2.0)
        took = time.perf_counter() - t0
    assert stopped and not pf.thread.is_alive()
    assert took < 2.0
