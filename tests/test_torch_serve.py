"""The port's ServeEngine vs the JAX ServeEngine on the conformance
suite's ``TINY`` config (f32, greedy, resort_every=2): generated tokens
identical and the stats counters both engines keep equal, across
slots {1, 4} x prefill_chunk {8, None} x decode_block {1, 4} x A^3
{off, conservative}. The same on its xLSTM config ``TINY_XL`` across
prefill_chunk {8, 64, None} x two admission orders (chunk 8 puts chunk
boundaries mid-prompt, so the mLSTM and sLSTM states carry across
dispatches), and with A^3 asked for, which the reference ignores on a
model with no attention. Plus the port's CLI on the CPU.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.config import A3Config  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

from test_torch_helpers import TINY, TINY_XL, port_a3, \
    port_cfg  # noqa: E402

torch.set_num_threads(1)

MAX_LEN = 96
MAX_NEW = 6
PROMPT_LENS = (5, 12, 23, 31, 9)
SHARED_STATS = ("prefill_tokens", "decode_steps", "decode_steps_advanced",
                "decode_dispatches", "prefill_dispatches", "host_syncs",
                "handoff_syncs", "ticks", "resorts", "submitted", "finished")


@pytest.fixture(scope="module")
def models():
    params = jdec.init_params(jax.random.PRNGKey(0), TINY)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                              port_cfg(TINY), device="cpu")
    return params, model


@pytest.fixture(scope="module")
def xl_models():
    params = jdec.init_params(jax.random.PRNGKey(2), TINY_XL)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                              port_cfg(TINY_XL), device="cpu")
    return params, model


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, TINY.vocab_size, size=n) for n in PROMPT_LENS]


def _run(engine, prompts, order="upfront"):
    """Submit all prompts up front, or one every other tick while the
    engine runs (``staggered``: later prompts prefill while earlier ones
    decode)."""
    if order == "upfront":
        uids = [engine.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
        engine.run_to_completion()
        return [engine.result(u) for u in uids]
    uids, pending = [], list(prompts)
    while pending or engine.in_flight:
        if pending and engine.stats["ticks"] % 2 == 0:
            uids.append(engine.submit(pending.pop(0),
                                      max_new_tokens=MAX_NEW))
        engine.step()
    return [engine.result(u) for u in uids]


@pytest.mark.parametrize("a3", ["off", "conservative"])
@pytest.mark.parametrize("decode_block", [1, 4])
@pytest.mark.parametrize("chunk", [8, None])
@pytest.mark.parametrize("slots", [1, 4])
def test_engine_matches_jax_engine(models, prompts, slots, chunk,
                                   decode_block, a3):
    params, model = models
    a3c = A3Config() if a3 == "off" else A3Config.conservative()
    kw = dict(slots=slots, max_len=MAX_LEN, prefill_chunk=chunk,
              resort_every=2, decode_block=decode_block)
    ref = JaxEngine(params, TINY, a3=a3c, **kw)
    port = ServeEngine(model, port_cfg(TINY), a3=port_a3(a3c), **kw)
    want, got = _run(ref, prompts), _run(port, prompts)
    assert got == want
    for key in SHARED_STATS:
        assert port.stats[key] == ref.stats[key], key
    assert all(port.status(u) == "finished" for u in range(len(prompts)))


@pytest.mark.parametrize("order", ["upfront", "staggered"])
@pytest.mark.parametrize("chunk", [8, 64, None])
def test_xlstm_engine_matches_jax_engine(xl_models, prompts, chunk, order):
    params, model = xl_models
    kw = dict(slots=2, max_len=MAX_LEN, prefill_chunk=chunk,
              decode_block=4)
    ref = JaxEngine(params, TINY_XL, **kw)
    port = ServeEngine(model, port_cfg(TINY_XL), **kw)
    want, got = _run(ref, prompts, order), _run(port, prompts, order)
    assert got == want
    for key in SHARED_STATS:
        assert port.stats[key] == ref.stats[key], key


def test_xlstm_engine_with_a3_asked_matches_jax_engine(xl_models, prompts):
    """A^3 on a model with no attention segment: the reference's engine
    runs it exactly (no sorted keys, no re-sorts); so does the port's."""
    params, model = xl_models
    kw = dict(slots=4, max_len=MAX_LEN, prefill_chunk=8, decode_block=4,
              resort_every=2)
    a3 = A3Config.conservative()
    ref = JaxEngine(params, TINY_XL, a3=a3, **kw)
    port = ServeEngine(model, port_cfg(TINY_XL), a3=port_a3(a3), **kw)
    want, got = _run(ref, prompts), _run(port, prompts)
    assert got == want
    assert port.stats["resorts"] == ref.stats["resorts"] == 0
    assert got == _run(ServeEngine(model, port_cfg(TINY_XL), **kw), prompts)


def test_handoff_only_prompt_reads_first_token_directly(models):
    """A budget-1 request finishes with its prefill token: no decode
    block rides, so the engine reads the handoff token directly."""
    params, model = models
    prompt = np.arange(10) % TINY.vocab_size
    ref = JaxEngine(params, TINY, slots=2, max_len=MAX_LEN)
    port = ServeEngine(model, port_cfg(TINY), slots=2, max_len=MAX_LEN)
    for eng in (ref, port):
        eng.submit(prompt, max_new_tokens=1)
        eng.run_to_completion()
    assert port.result(0) == ref.result(0)
    assert port.stats["handoff_syncs"] == ref.stats["handoff_syncs"] == 1


def test_submit_validates(models):
    _, model = models
    eng = ServeEngine(model, port_cfg(TINY), slots=1, max_len=16)
    with pytest.raises(ValueError):
        eng.submit(np.zeros((0,), np.int32))
    with pytest.raises(ValueError):
        eng.submit(np.zeros((17,), np.int32))
    with pytest.raises(ValueError):
        eng.submit(np.array([TINY.vocab_size]))
    with pytest.raises(TypeError):
        eng.submit(np.array([0.5]))


def test_cli_smoke_runs_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "phi4-mini-3.8b", "--smoke", "--device", "cpu",
          "--requests", "3", "--slots", "2", "--prompt-len", "12",
          "--max-new", "3", "--a3", "conservative", "--decode-block", "2"])
    out = capsys.readouterr().out
    assert "arch=phi4-mini-3.8b a3=conservative requests=3/3" in out
    assert "new_tokens=9" in out


def test_cli_xlstm_smoke_runs_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "xlstm-350m", "--smoke", "--device", "cpu",
          "--requests", "3", "--slots", "2", "--prompt-len", "20",
          "--max-new", "4", "--prefill-chunk", "8", "--decode-block", "2"])
    out = capsys.readouterr().out
    assert "arch=xlstm-350m a3=off requests=3/3" in out
    assert "new_tokens=12" in out
