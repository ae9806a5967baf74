"""Shared helpers of the PyTorch-port parity tests (``test_torch_*``),
plus checks that the port's configuration mirrors the reference's.

Inputs are made with numpy from a fixed seed and handed to both
packages; JAX stays on the CPU and data crosses as numpy arrays.
Tolerances follow ``tests/test_kernels.py``: 2e-5 in float32, 2e-2 in
bfloat16; integer and boolean outputs must be equal. This module does
not import JAX (``repro.config`` is stdlib only), so card-only tests
that use it also run on a machine without JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import config as jcfg  # noqa: E402
from repro_torch import config as tcfg  # noqa: E402

torch.set_num_threads(1)

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)

# the conformance suite's tiny attention config (tests/test_serve_conformance)
TINY = jcfg.ModelConfig("tiny", "dense", num_layers=2, d_model=64,
                        num_heads=4, num_kv_heads=2, d_ff=128,
                        vocab_size=256, head_dim=16, dtype="float32")
# and its xlstm-like mLSTM/mLSTM/sLSTM config (no FFN)
TINY_XL = jcfg.ModelConfig("tiny-xl", "ssm", num_layers=3, d_model=64,
                           num_heads=4, num_kv_heads=4, d_ff=0,
                           vocab_size=256, head_dim=16,
                           block_pattern=(jcfg.BlockKind.MLSTM,
                                          jcfg.BlockKind.MLSTM,
                                          jcfg.BlockKind.SLSTM),
                           dtype="float32")
# and its RG-LRU hybrid (RG-LRU, RG-LRU, sliding attention; GELU FFN)
TINY_RG = jcfg.ModelConfig("tiny-rg", "hybrid", num_layers=3, d_model=64,
                           num_heads=4, num_kv_heads=2, d_ff=128,
                           vocab_size=256, head_dim=16,
                           attention_kind=jcfg.AttentionKind.SLIDING,
                           window_size=24,
                           block_pattern=(jcfg.BlockKind.RGLRU,
                                          jcfg.BlockKind.RGLRU,
                                          jcfg.BlockKind.ATTENTION),
                           act="gelu", dtype="float32")
# TINY with a 16-row sliding window (the conformance suite's ring-wrap
# config), and a local/global pattern over 4 layers: local, global,
# local, global (each global layer a segment of its own, with A^3)
TINY_SWA = dataclasses.replace(TINY, name="tiny-swa",
                               attention_kind=jcfg.AttentionKind.SLIDING,
                               window_size=16)
TINY_LG = dataclasses.replace(TINY, name="tiny-lg", num_layers=4,
                              attention_kind=jcfg.AttentionKind.LOCAL_GLOBAL,
                              local_global_pattern=1, window_size=16)


def tol(dtype) -> dict:
    """Tolerance of a dtype given by name or as a jnp/torch dtype."""
    return BF16_TOL if "bfloat16" in str(dtype) else F32_TOL


def port_cfg(cfg: jcfg.ModelConfig) -> tcfg.ModelConfig:
    """The port's ModelConfig with the same fields as a reference one."""
    kw = {f.name: getattr(cfg, f.name)
          for f in dataclasses.fields(jcfg.ModelConfig)}
    if cfg.moe is not None:
        kw["moe"] = tcfg.MoEConfig(**dataclasses.asdict(cfg.moe))
    kw["attention_kind"] = tcfg.AttentionKind(cfg.attention_kind.value)
    kw["block_pattern"] = tuple(tcfg.BlockKind(b.value)
                                for b in cfg.block_pattern)
    return tcfg.ModelConfig(**kw)


def port_a3(a3: jcfg.A3Config) -> tcfg.A3Config:
    kw = {f.name: getattr(a3, f.name)
          for f in dataclasses.fields(jcfg.A3Config)}
    kw["mode"] = tcfg.A3Mode(a3.mode.value)
    return tcfg.A3Config(**kw)


def T(x, dtype=None) -> "torch.Tensor":
    """numpy / jax array -> CPU torch tensor (bf16 via float32, exact)."""
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    t = torch.from_numpy(np.array(arr))
    return t if dtype is None else t.to(dtype)


def N(x) -> np.ndarray:
    """torch tensor or jax array -> numpy (bf16 widened to float32)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.detach().cpu().numpy()
    arr = np.asarray(x)
    return arr.astype(np.float32) if arr.dtype.name == "bfloat16" else arr


def assert_nan_and_zero_rows(got, want, rtol, atol):
    """The same NaN entries and the same all-zero rows (last axis) as
    ``want``; every other entry within the tolerance."""
    got, want = N(got), N(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal((got == 0).all(-1), (want == 0).all(-1))
    fin = ~np.isnan(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol)


def cache_to_torch(cache) -> dict:
    return {seg: {name: T(leaf) for name, leaf in sc.items()}
            for seg, sc in cache.items()}


def assert_cache_close(port_cache, ref_cache, rtol, atol):
    """Leaf for leaf: float leaves within tolerance, integer leaves
    equal."""
    assert set(port_cache) == set(ref_cache)
    for seg, sc in ref_cache.items():
        assert set(port_cache[seg]) == set(sc), seg
        for name, leaf in sc.items():
            a, b = N(port_cache[seg][name]), N(leaf)
            assert a.shape == b.shape, (seg, name)
            if np.issubdtype(b.dtype, np.integer):
                np.testing.assert_array_equal(a, b, err_msg=f"{seg}.{name}")
            else:
                np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                           err_msg=f"{seg}.{name}")


# ---------------------------------------------------------------------------
# serving-engine runs shared by the port's engine tests
# ---------------------------------------------------------------------------

# the engine counters that do not depend on the wall clock
ENGINE_STATS = ("prefill_tokens", "decode_steps", "decode_steps_advanced",
                "decode_dispatches", "decode_blocks", "prefill_dispatches",
                "host_syncs", "handoff_syncs", "ticks", "resorts",
                "adaptive_shrink_ticks", "submitted", "finished",
                "rejected", "cancelled", "expired", "failed",
                "max_ticks_exhausted")


def check_conservation(eng):
    s = eng.stats
    assert s["submitted"] == (s["finished"] + s["rejected"]
                              + s["cancelled"] + s["expired"]
                              + s["failed"] + eng.in_flight), s


def drive(eng, prompts, *, order="upfront", max_new=6, on_tick=None):
    """Serve ``prompts`` on either engine -> ({i: result}, {i: uid}).
    ``upfront`` / ``reversed`` submit all before the first tick,
    ``staggered`` one every other tick; ``on_tick(eng)`` runs after
    every tick."""
    uids = {}
    pending = list(enumerate(prompts))
    if order == "reversed":
        pending.reverse()
    if order in ("upfront", "reversed"):
        for i, p in pending:
            uids[i] = eng.submit(p, max_new_tokens=max_new)
        pending = []
    elif order != "staggered":
        raise ValueError(order)
    while pending or eng.in_flight:
        if pending and eng.stats["ticks"] % 2 == 0:
            i, p = pending.pop(0)
            uids[i] = eng.submit(p, max_new_tokens=max_new)
        eng.step()
        if on_tick is not None:
            on_tick(eng)
    return {i: eng.result(u) for i, u in uids.items()}, uids


def assert_same_stats(port, ref, keys=ENGINE_STATS):
    for key in keys:
        assert port.stats[key] == ref.stats[key], \
            (key, port.stats[key], ref.stats[key])


def assert_engine_invariants(eng):
    """The dispatch and sync bounds of tests/test_serve_conformance.py."""
    t, s = eng.decode_block, eng.stats
    assert s["decode_steps"] == t * s["decode_dispatches"]
    adv = s["decode_steps_advanced"]
    assert s["decode_dispatches"] <= adv <= s["decode_steps"]
    assert s["decode_dispatches"] <= (math.ceil(adv / t)
                                      + s["prefill_dispatches"])
    assert s["prefill_dispatches"] <= s["ticks"]
    assert s["host_syncs"] <= s["decode_dispatches"] + s["handoff_syncs"]
    assert s["handoff_syncs"] <= s["prefill_dispatches"]
    bound = math.ceil(s["decode_steps"] / t) + s["prefill_dispatches"]
    assert s["decode_dispatches"] <= bound
    assert s["host_syncs"] <= bound


@contextlib.contextmanager
def jax_blocks_ready():
    """While active, the JAX engine's readiness probe waits for a block
    and says it is done, as eager CPU torch has always computed it. The
    deferred-harvest drains of both engines then land the same blocks
    on the same ticks, and every counter of ``ENGINE_STATS`` compares
    at ``pipeline_depth > 0`` too."""
    import jax
    from repro.serve import engine as jeng
    saved = jeng._block_done
    jeng._block_done = lambda arr: jax.block_until_ready(arr) is not None
    try:
        yield
    finally:
        jeng._block_done = saved


def nan_lane_(cache, si):
    """NaN every floating leaf of lane ``si`` in a port cache, in place
    (what ``repro.serve.chaos.corrupt_cache_lane`` does to a JAX
    cache)."""
    for sc in cache.values():
        for leaf in sc.values():
            if leaf.is_floating_point():
                leaf[:, si] = float("nan")


@pytest.fixture
def cuda():
    """The CUDA device, or a skip when the machine has no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# the port's configuration mirrors the reference's
# ---------------------------------------------------------------------------

def test_phi4_config_matches_reference():
    ref = jcfg.get_arch("phi4-mini-3.8b")
    port = tcfg.get_arch("phi4-mini-3.8b")
    assert port == port_cfg(ref)
    assert tcfg.smoke_variant(port) == port_cfg(jcfg.smoke_variant(ref))


def test_xlstm_config_matches_reference():
    ref = jcfg.get_arch("xlstm-350m")
    port = tcfg.get_arch("xlstm-350m")
    assert port == port_cfg(ref)
    assert tcfg.smoke_variant(port) == port_cfg(jcfg.smoke_variant(ref))


def test_unported_arch_raises():
    """A name neither package registers raises, as in the reference."""
    assert "gpt-2" not in jcfg.list_archs()
    with pytest.raises(KeyError, match="unknown arch"):
        jcfg.get_arch("gpt-2")
    with pytest.raises(KeyError, match="unknown arch"):
        tcfg.get_arch("gpt-2")


@pytest.mark.parametrize("mode", ["conservative", "aggressive"])
@pytest.mark.parametrize("n", [1, 7, 96, 512, 4096])
def test_a3_config_matches_reference(mode, n):
    ref = getattr(jcfg.A3Config, mode)()
    port = getattr(tcfg.A3Config, mode)()
    assert port == port_a3(ref)
    assert port.m_for(n) == ref.m_for(n)
    assert port.threshold_nats == ref.threshold_nats


def test_serve_config_validates():
    with pytest.raises(ValueError):
        tcfg.ServeConfig(slots=0)
    with pytest.raises(ValueError):
        tcfg.ServeConfig(decode_block=0)
    with pytest.raises(ValueError):
        tcfg.ServeConfig(prefill_chunk=0)


def test_serve_config_fields_match_reference():
    """Every field the port's ServeConfig has, the reference's has, with
    the same default."""
    ref = jcfg.ServeConfig()
    for f in dataclasses.fields(tcfg.ServeConfig):
        assert getattr(tcfg.ServeConfig(), f.name) == getattr(ref, f.name), \
            f.name


@pytest.mark.parametrize("bad", [
    dict(prefill_chunk_min=0), dict(prefill_chunk=8, prefill_chunk_min=9),
    dict(pipeline_depth=-1), dict(temperature=-0.1), dict(max_queue=-1),
    dict(shed_policy="drop-the-table"), dict(deadline_ticks=0),
    dict(retain_results=-1), dict(page_size=0), dict(cache_pages=-1),
    dict(kv_quant="fp8"), dict(l2_bytes=-1), dict(telemetry_every=0),
    dict(trace_events=0)], ids=lambda kw: next(iter(kw)))
def test_serve_config_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError):
        jcfg.ServeConfig(**bad)
    with pytest.raises(ValueError):
        tcfg.ServeConfig(**bad)


def test_entry_points_default_to_cuda():
    """No silent CPU fallback: without a card the default device raises;
    only an explicit ``device="cpu"`` runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from repro_torch.models import decoder
    cfg = port_cfg(TINY)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        decoder.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        decoder.init_params(cfg, torch.Generator())
    assert decoder.init_cache(cfg, 1, 8, device="cpu")["seg0"]["k"].is_cpu
