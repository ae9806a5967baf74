"""The port's ServeEngine vs the JAX ServeEngine on the conformance
suite's ``TINY`` config (f32, greedy, resort_every=2): generated tokens
identical and every counter that does not read the clock equal, over
the reference's conformance grid (``tests/test_serve_conformance.py``:
prefill_chunk {8, 64, None} x decode_block {1, 4, 16} x A^3 {off,
conservative}, at slots 4, and at one slot for chunk {8, None} x
decode_block {1, 4}) with its dispatch and sync
invariants, and its other cases: mixed prefill/decode ticks, the
host-syncs-per-token bound, A^3 across re-sort boundaries and the device
watermark, one-step ``decode_block`` = ``decode_step``, the exhausted
lane that rides along. The same on its xLSTM config ``TINY_XL`` across
prefill_chunk {8, 64, None} x two admission orders (chunk 8 puts chunk
boundaries mid-prompt, so the mLSTM and sLSTM states carry across
dispatches), and with A^3 asked for, which the reference ignores on a
model with no attention. Plus the port's CLI on the CPU, with the
lifecycle, pipeline and sampling flags.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import A3Config  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

from test_torch_helpers import TINY, TINY_XL, N, T, \
    assert_engine_invariants, assert_same_stats, drive, port_a3, \
    port_cfg  # noqa: E402

torch.set_num_threads(1)

MAX_LEN = 96
MAX_NEW = 6
PROMPT_LENS = (5, 12, 23, 31, 9)


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
    decode) -> results in prompt order."""
    return list(drive(engine, prompts, order=order, max_new=MAX_NEW)[0]
                .values())


# (slots, chunk, decode_block): the reference's grid at 4 slots, and
# one slot at chunk {8, None} x decode_block {1, 4}
GRID = [(4, c, t) for c in (8, 64, None) for t in (1, 4, 16)] + \
    [(1, c, t) for c in (8, None) for t in (1, 4)]


@pytest.mark.parametrize("a3", ["off", "conservative"])
@pytest.mark.parametrize("slots,chunk,decode_block", GRID)
def test_engine_matches_jax_engine(models, prompts, slots, chunk,
                                   decode_block, a3):
    """The reference's conformance grid (chunk {8, 64, None} x
    decode_block {1, 4, 16} x A^3); MAX_NEW 6 < 16 forces mid-block
    finishes at decode_block 16, and a partial second block at 4."""
    params, model = models
    a3c = A3Config() if a3 == "off" else A3Config.conservative()
    kw = dict(slots=slots, max_len=MAX_LEN, prefill_chunk=chunk,
              resort_every=2, decode_block=decode_block)
    ref = JaxEngine(params, TINY, a3=a3c, **kw)
    port = ServeEngine(model, port_cfg(TINY), a3=port_a3(a3c), **kw)
    want, got = _run(ref, prompts), _run(port, prompts)
    assert got == want
    assert_same_stats(port, ref)
    assert_engine_invariants(port)
    assert all(port.status(u) == "finished" for u in range(len(prompts)))


# ---------------------------------------------------------------------------
# the rest of the reference's conformance cases, each against the JAX
# engine
# ---------------------------------------------------------------------------

def _pair(models, *, a3="off", **kw):
    params, model = models
    a3c = A3Config() if a3 == "off" else A3Config.conservative()
    kw = {"slots": 4, "max_len": MAX_LEN, **kw}
    return (JaxEngine(params, TINY, a3=a3c, **kw),
            ServeEngine(model, port_cfg(TINY), a3=port_a3(a3c), **kw))


def _both(models, prompts, order="upfront", **kw):
    ref, port = _pair(models, **kw)
    want, _ = drive(ref, prompts, order=order, max_new=MAX_NEW)
    got, _ = drive(port, prompts, order=order, max_new=MAX_NEW)
    assert got == want
    assert all(r is not None and len(r) == MAX_NEW for r in got.values())
    assert_same_stats(port, ref)
    assert_engine_invariants(port)
    return got, port


@pytest.mark.parametrize("order", ["reversed", "staggered"])
@pytest.mark.parametrize("block", [4, 16])
def test_blocked_decode_mixed_prefill_decode_ticks(models, prompts, block,
                                                   order):
    """Ticks where some lanes prefill a chunk while others run a decode
    block; admission order changes no output."""
    got, _ = _both(models, prompts, order=order, prefill_chunk=8,
                   decode_block=block)
    _, upfront = _pair(models, prefill_chunk=8, decode_block=block)
    assert got == drive(upfront, prompts, max_new=MAX_NEW)[0]


def test_blocked_decode_cuts_host_syncs_per_token(models, prompts):
    outs, stats = {}, {}
    for block in (1, 8):
        outs[block], eng = _both(models, prompts, prefill_chunk=64,
                                 decode_block=block)
        stats[block] = eng.stats
    assert outs[1] == outs[8]
    assert stats[8]["decode_dispatches"] < stats[1]["decode_dispatches"]
    assert stats[8]["host_syncs"] < stats[1]["host_syncs"]


@pytest.mark.parametrize("block", [4, 16])
def test_a3_blocked_decode_across_resort_boundaries(models, prompts, block):
    """The watermark check fires mid-block: the blocked engine replays the
    per-step engine's schedule, tokens and re-sort count."""
    kw = dict(slots=2, prefill_chunk=8, a3="conservative", resort_every=2)
    ref_out, ref_eng = _both(models, prompts[:3], decode_block=1, **kw)
    out, eng = _both(models, prompts[:3], decode_block=block, **kw)
    assert ref_eng.stats["resorts"] > 0
    assert out == ref_out
    assert eng.stats["resorts"] == ref_eng.stats["resorts"]


@pytest.mark.parametrize("resort_every", [0, 2])
def test_in_graph_resort_advances_device_watermark(models, resort_every):
    """The device ``sorted_upto`` ends where the host mirror predicts and
    where the JAX engine's ends; resort_every 0 is clamped to 1."""
    plen, new = 10, 5
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, TINY.vocab_size, size=plen)
    ref, eng = _pair(models, slots=1, prefill_chunk=8, a3="conservative",
                     resort_every=resort_every, decode_block=4)
    for e in (ref, eng):
        e.submit(prompt, max_new_tokens=new)
        e.run_to_completion()
    upto, resorts = plen, 0
    for pos in range(plen, plen + new - 1):
        if pos - upto >= max(1, resort_every):
            upto, resorts = pos, resorts + 1
    dev = eng.cache["seg0"]["sorted_upto"]
    assert int(dev[0, 0]) == upto
    np.testing.assert_array_equal(
        N(dev), np.asarray(ref.cache["seg0"]["sorted_upto"]))
    assert eng.stats["resorts"] == ref.stats["resorts"] == \
        resorts * eng._n_a3_segs
    assert resorts > 0


def _prefilled(models):
    params, model = models
    rng = np.random.default_rng(5)
    p = rng.integers(0, TINY.vocab_size, size=(2, 9))
    _, jc = jdec.prefill(params, TINY, jnp.asarray(p, jnp.int32),
                         max_len=32)
    tc = {seg: {k: T(v) for k, v in sc.items()} for seg, sc in jc.items()}
    return params, model, jc, tc


def test_decode_block_one_step_equals_decode_step(models):
    """``decode_block(steps=1)`` is ``decode_step`` + argmax: the same
    token as the step's logits, the carry that token, the same cache;
    and the JAX block's token."""
    params, model, jc, tc = _prefilled(models)
    cfg = port_cfg(TINY)
    tok = torch.tensor([5, 6], dtype=torch.int32)
    pos = torch.tensor([9, 9], dtype=torch.int32)
    lg, c_ref = tdec.decode_step(model, cfg, {s: {k: v.clone() for k, v in
                                                  sc.items()}
                                              for s, sc in tc.items()},
                                 tok, pos)
    ring, carry, c_blk = tdec.decode_block(model, cfg, tc, tok, pos,
                                           torch.ones(2, dtype=torch.int32),
                                           steps=1)
    assert carry.tolist() == ring[:, 0].tolist()
    assert ring[:, 0].tolist() == torch.argmax(lg, -1).tolist()
    for seg, sc in c_ref.items():
        for k, v in sc.items():
            assert torch.equal(c_blk[seg][k], v), (seg, k)
    jring, _, _ = jdec.decode_block(params, TINY, jc, jnp.asarray([5, 6]),
                                    jnp.asarray([9, 9]), jnp.asarray([1, 1]),
                                    steps=1)
    assert ring.tolist() == np.asarray(jring).tolist()


def test_decode_block_exhausted_lane_rides_along(models):
    """A lane whose steps_left hits 0 mid-block freezes: ring entries -1,
    its carry the last token it emitted, its cache rows those of a
    2-step block of that lane alone; the JAX block's ring."""
    params, model, jc, tc = _prefilled(models)
    cfg = port_cfg(TINY)
    tok = torch.tensor([5, 6], dtype=torch.int32)
    pos = torch.tensor([9, 9], dtype=torch.int32)
    alone = {s: {k: v[:, 1:2].clone() for k, v in sc.items()}
             for s, sc in tc.items()}
    ring, carry, c_blk = tdec.decode_block(
        model, cfg, tc, tok, pos, torch.tensor([4, 2], dtype=torch.int32),
        steps=4)
    r = ring.tolist()
    assert min(r[0]) >= 0
    assert min(r[1][:2]) >= 0 and r[1][2:] == [-1, -1]
    assert carry.tolist() == [r[0][-1], r[1][1]]
    _, _, c_one = tdec.decode_block(model, cfg, alone, tok[1:], pos[1:],
                                    torch.tensor([2], dtype=torch.int32),
                                    steps=2)
    for seg, sc in c_one.items():
        for k, v in sc.items():
            torch.testing.assert_close(c_blk[seg][k][:, 1:2], v, rtol=1e-6,
                                       atol=1e-6)
    jring, _, _ = jdec.decode_block(params, TINY, jc, jnp.asarray([5, 6]),
                                    jnp.asarray([9, 9]), jnp.asarray([4, 2]),
                                    steps=4)
    assert r == np.asarray(jring).tolist()


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
    assert_same_stats(port, ref)


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


def test_cli_lifecycle_pipeline_and_sampling_flags(capsys):
    """The reference CLI's knobs: a tempered, pipelined serve with a
    bounded queue prints the reference's summary keys; the queue of 2
    sheds the oldest of the 5 requests beyond it."""
    from repro_torch.launch.serve import main
    main(["--arch", "phi4-mini-3.8b", "--smoke", "--device", "cpu",
          "--requests", "5", "--slots", "2", "--prompt-len", "12",
          "--max-new", "3", "--temperature", "0.8", "--pipeline-depth", "1",
          "--max-queue", "2", "--shed-policy", "evict-oldest-queued",
          "--deadline-ticks", "50", "--prefill-chunk-min", "4",
          "--prefill-chunk", "8", "--retain-results", "16",
          "--decode-block", "2"])
    out = capsys.readouterr().out
    for key in ("arch=phi4-mini-3.8b a3=off requests=2/5", "new_tokens=6",
                "tok/s", "statuses={'rejected': 3, 'finished': 2}",
                "'host_sync_stalls'", "'tick_ns_decode'",
                "'adaptive_shrink_ticks'", "stats="):
        assert key in out, key


def _cli_pair(monkeypatch):
    """Both CLIs on one footing: their smoke config taken in float32, the
    port CLI serving the JAX CLI's weights (its seed-0 init, converted),
    each prompt draw given a shared 24-token head, and every engine
    either CLI builds (``from_config`` or ``restore``) kept -> the dict
    that collects them under "jax" / "port" (a later build of one CLI
    replaces its earlier one)."""
    import dataclasses
    import types

    from repro import config as jcfg
    from repro.launch import serve as jcli
    from repro_torch.launch import serve as tcli

    def f32(smoke):
        return lambda c: dataclasses.replace(smoke(c), dtype="float32")

    monkeypatch.setattr(jcli, "smoke_variant", f32(jcli.smoke_variant))
    monkeypatch.setattr(tcli, "smoke_variant", f32(tcli.smoke_variant))
    cfg = jcli.smoke_variant(jcfg.get_arch("phi4-mini-3.8b"))
    params = jdec.init_params(jax.random.PRNGKey(0), cfg)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                              port_cfg(cfg), device="cpu")
    monkeypatch.setattr(tdec, "init_params", lambda *a, **k: model)

    class SharedHead:
        def __init__(self, seed):
            self.rng = np.random.default_rng(seed)
            self.head = self.rng.integers(0, cfg.vocab_size, size=24)

        def integers(self, lo, hi, size):
            return np.concatenate([self.head, self.rng.integers(
                lo, hi, size=size - len(self.head))])

    shim = types.SimpleNamespace(random=types.SimpleNamespace(
        default_rng=SharedHead))
    monkeypatch.setattr(jcli, "np", shim)
    monkeypatch.setattr(tcli, "np", shim)
    engines = {}
    for key, cls in (("jax", JaxEngine), ("port", ServeEngine)):
        for build in ("from_config", "restore"):
            made = getattr(cls, build).__func__

            def keep(c, *a, _k=key, _m=made, **kw):
                engines[_k] = _m(c, *a, **kw)
                return engines[_k]
            monkeypatch.setattr(cls, build, classmethod(keep))
    return engines, jcli, tcli


def test_cli_prefix_cache_flags_match_reference_cli(monkeypatch, capsys):
    """``--cache-pages 16 --page-size 8 --kv-quant int8 --a3
    conservative`` on both CLIs (their other flags at their defaults: 8
    requests of 64 tokens, 4 slots, 32 new tokens): each CLI's prompt
    draw gets a shared 24-token head, and the port CLI serves the JAX
    CLI's weights (its seed-0 init, converted). The requests admitted
    after the first four hit the trie; tokens and prefix counters are
    equal. Both CLIs' smoke config is taken in float32, where parity is
    asserted token for token: in bf16 request 1's first logits hold an
    exact tie in JAX (ROADMAP queue 3, entry 2)."""
    import sys

    engines, jcli, tcli = _cli_pair(monkeypatch)
    flags = ["--arch", "phi4-mini-3.8b", "--smoke", "--cache-pages", "16",
             "--page-size", "8", "--kv-quant", "int8", "--a3",
             "conservative"]
    monkeypatch.setattr(sys, "argv", ["serve"] + flags)
    jcli.main()
    tcli.main(flags + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("arch=phi4-mini-3.8b a3=conservative requests=8/8") == 2
    ref, port = engines["jax"], engines["port"]
    assert port._pc.kv_quant == "int8" and port._pc.page_size == 8
    assert [port.result(u) for u in range(8)] == \
        [ref.result(u) for u in range(8)]
    assert port.stats["prefix_hits"] > 0
    for key in ("prefix_hits", "prefix_tokens_reused", "gather_dispatches",
                "pages_recorded", "pages_evicted", "prefill_tokens"):
        assert port.stats[key] == ref.stats[key], key


def test_cli_durable_state_and_chaos_flags_match_reference_cli(
        monkeypatch, capsys, tmp_path):
    """``--l2-bytes``, ``--checkpoint-dir``, ``--restore``,
    ``--chaos-rate`` and ``--chaos-seed`` on both CLIs (float32 smoke
    config, shared weights, prompts with a shared 24-token head, a 6-page
    pool of 8-token pages so that pages demote to L2): a first run with
    chaos at rate 0.2 writes a checkpoint, a second run restores it and
    serves the same prompts again (the same seed), promoting their pages
    from the restored L2. Both print the reference's
    lines (the chaos line equal, events and victims), and statuses,
    tokens and the L2, chaos and checkpoint counters are equal."""
    import sys

    engines, jcli, tcli = _cli_pair(monkeypatch)
    base = ["--arch", "phi4-mini-3.8b", "--smoke", "--requests", "6",
            "--slots", "2", "--prompt-len", "40", "--max-new", "4",
            "--cache-pages", "6", "--page-size", "8", "--l2-bytes",
            str(1 << 24), "--decode-block", "2"]
    keys = ("l2_spills", "l2_hits", "l2_evictions", "l2_integrity_drops",
            "chaos_aborted_ticks", "chaos_delayed_ticks", "checkpoints",
            "restores", "failed", "finished", "prefix_hits",
            "prefix_tokens_reused", "pages_evicted", "prefill_tokens",
            "ticks")
    for extra in (["--chaos-rate", "0.2", "--chaos-seed", "3"],
                  ["--restore"]):
        lines = {}
        for who, cli in (("jax", jcli), ("port", tcli)):
            flags = base + extra + ["--checkpoint-dir",
                                    str(tmp_path / who)]
            if who == "jax":
                monkeypatch.setattr(sys, "argv", ["serve"] + flags)
                cli.main()
            else:
                cli.main(flags + ["--device", "cpu"])
            lines[who] = capsys.readouterr().out.splitlines()
        ref, port = engines["jax"], engines["port"]
        n = ref._uid
        assert port._uid == n
        assert [port.status(u) for u in range(n)] == \
            [ref.status(u) for u in range(n)]
        assert [port.result(u) for u in range(n)] == \
            [ref.result(u) for u in range(n)]
        for key in keys:
            assert port.stats[key] == ref.stats[key], key
        for who in ("jax", "port"):
            assert lines[who][-1] == (f"checkpointed engine to "
                                      f"{tmp_path / who}")
        if "--restore" in extra:
            assert lines["jax"][0] == lines["port"][0].replace(
                str(tmp_path / "port"), str(tmp_path / "jax"))
            assert lines["port"][0].startswith("restored engine from")
            assert port.stats["restores"] == 1
            # the second run draws the first run's prompts (the same
            # seed): their demoted pages come back from the restored L2
            assert port.stats["l2_hits"] > 0
        else:
            chaos = [ln for ln in lines["port"] if ln.startswith("chaos:")]
            assert chaos and chaos == [ln for ln in lines["jax"]
                                       if ln.startswith("chaos:")]
            assert port.stats["l2_spills"] > 0


def test_cli_telemetry_flags_match_reference_cli(monkeypatch, capsys,
                                                 tmp_path):
    """``--telemetry --telemetry-every 2 --stats-json --metrics-json
    --trace-out`` with A^3 conservative on both CLIs (float32 smoke
    config, shared weights, prompts with a shared 24-token head): equal
    tokens; the stats snapshots share their schema, top-level and config
    keys, and their ``stats`` are equal but for the clock-timed keys; the
    metrics snapshots (in the stats file and in the metrics file) have
    the same schema, counter and histogram names, equal counters but the
    clock-timed ones, and equal probe histograms; both traces load, with
    the same schema."""
    import json
    import sys

    engines, jcli, tcli = _cli_pair(monkeypatch)
    base = ["--arch", "phi4-mini-3.8b", "--smoke", "--requests", "4",
            "--prompt-len", "32", "--max-new", "6", "--decode-block", "2",
            "--a3", "conservative", "--telemetry", "--telemetry-every", "2"]
    out = {}
    for who, cli in (("jax", jcli), ("port", tcli)):
        files = {f: str(tmp_path / f"{who}_{f}.json")
                 for f in ("stats", "metrics", "trace")}
        flags = base + ["--stats-json", files["stats"], "--metrics-json",
                        files["metrics"], "--trace-out", files["trace"]]
        if who == "jax":
            monkeypatch.setattr(sys, "argv", ["serve"] + flags)
            cli.main()
        else:
            cli.main(flags + ["--device", "cpu"])
        out[who] = {f: json.loads(open(p).read()) for f, p in files.items()}
    lines = capsys.readouterr().out
    assert lines.count("wrote engine stats to") == 2
    ref, port = engines["jax"], engines["port"]
    assert [port.result(u) for u in range(4)] == \
        [ref.result(u) for u in range(4)]
    wall = ("tick_ns_prefill", "tick_ns_decode", "tick_ns_harvest",
            "tick_ns_host", "host_sync_stalls")
    j, p = out["jax"]["stats"], out["port"]["stats"]
    assert j["schema"] == p["schema"] == "a3-serve-stats/v2"
    assert set(j) == set(p) == {"schema", "config", "stats", "metrics"}
    assert set(j["config"]) == set(p["config"])
    assert p["config"]["serve"]["telemetry"] is True
    assert set(j["stats"]) == set(p["stats"])
    assert {k: v for k, v in p["stats"].items() if k not in wall} == \
        {k: v for k, v in j["stats"].items() if k not in wall}
    for jm, pm in ((j["metrics"], p["metrics"]),
                   (out["jax"]["metrics"], out["port"]["metrics"])):
        assert jm["schema"] == pm["schema"] == "a3-serve-metrics/v1"
        assert set(jm["counters"]) == set(pm["counters"])
        assert set(jm["histograms"]) == set(pm["histograms"])
        for k, v in pm["counters"].items():
            if k[len("serve_"):] not in wall:
                assert v == jm["counters"][k], k
        for k in ("serve_a3_candidates", "serve_a3_captured_mass"):
            assert pm["histograms"][k]["counts"] == \
                jm["histograms"][k]["counts"], k
    assert p["metrics"]["counters"]["serve_a3_probe_samples"] > 0
    for who in ("jax", "port"):
        tr = out[who]["trace"]
        assert tr["otherData"]["schema"] == "a3-serve-trace/v1"
        assert {"submit", "decode_block", "terminal"} <= {
            e["name"] for e in tr["traceEvents"]}
