"""The port's data pipelines (``repro_torch.data``, numpy only) are
bit-equal to the JAX package's for the same seeds: ``make_lm_batch``,
``SyntheticLM`` (its prefetch thread, ``state`` and ``restore`` at a
cursor), ``make_task`` and ``generate_babi``; plus
``tests/test_substrate.py``'s data cases restated on the port."""
from __future__ import annotations

import numpy as np
import pytest

from repro.data import babi as jbabi  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.data import babi as tbabi  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("step,batch,seq,vocab,seed", [
    (0, 4, 64, 1000, 0), (7, 2, 32, 256, 3), (123, 3, 130, 50304, 11)])
def test_make_lm_batch_bit_equal(step, batch, seq, vocab, seed):
    _equal(tsyn.make_lm_batch(step, batch, seq, vocab, seed),
           jsyn.make_lm_batch(step, batch, seq, vocab, seed))


def test_synthetic_lm_stream_and_restore_bit_equal():
    t, j = tsyn.SyntheticLM(4, 32, 500, seed=5), \
        jsyn.SyntheticLM(4, 32, 500, seed=5)
    try:
        for _ in range(3):
            _equal(next(t), next(j))
        assert t.state == j.state == {"step": 3, "seed": 5}
    finally:
        t.close()
        j.close()
    t = tsyn.SyntheticLM.restore({"step": 6, "seed": 5}, 4, 32, 500)
    try:
        _equal(next(t), jsyn.make_lm_batch(6, 4, 32, 500, 5))
        assert t.state == {"step": 7, "seed": 5}
    finally:
        t.close()


@pytest.mark.parametrize("kw,batch,n,seed", [
    (dict(), 16, 20, 1),                                   # repeats
    (dict(num_actors=32, num_places=8, max_sentences=24, max_words=8),
     64, 20, 100),                                         # unique actors
    (dict(num_actors=64, num_places=16, max_sentences=64), 8, 48, 7)])
def test_babi_bit_equal(kw, batch, n, seed):
    tt, jt = tbabi.make_task(**kw), jbabi.make_task(**kw)
    assert tuple(tt) == tuple(jt)
    _equal(tbabi.generate_babi(tt, batch, n, seed),
           jbabi.generate_babi(jt, batch, n, seed))


def test_lm_batch_deterministic_and_restartable():
    b1 = tsyn.make_lm_batch(7, 4, 64, 1000, seed=3)
    b2 = tsyn.make_lm_batch(7, 4, 64, 1000, seed=3)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert (b1["labels"][:, :-1] == b1["tokens"][:, 1:]).all()

    pipe = tsyn.SyntheticLM(4, 64, 1000, seed=3)
    first = next(pipe)
    state = pipe.state
    pipe.close()
    pipe2 = tsyn.SyntheticLM.restore(state, 4, 64, 1000)
    second = next(pipe2)
    pipe2.close()
    expect = tsyn.make_lm_batch(1, 4, 64, 1000, seed=3)
    np.testing.assert_array_equal(second["tokens"], expect["tokens"])
    np.testing.assert_array_equal(
        first["tokens"], tsyn.make_lm_batch(0, 4, 64, 1000, 3)["tokens"])


def test_babi_generator_answers_consistent():
    task = tbabi.make_task()
    data = tbabi.generate_babi(task, 16, 20, seed=1)
    for b in range(16):
        actor = data["question"][b, 2]
        place = None
        for s in range(20):
            if data["sentences"][b, s, 0] == actor:
                place = data["sentences"][b, s, 2]
        assert place is not None and place == data["answer"][b]
