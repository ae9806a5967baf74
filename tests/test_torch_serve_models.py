"""The port's ServeEngine vs the JAX ServeEngine on the model kinds of the
later families, float32 and greedy: generated tokens identical and every
counter that does not read the clock equal (``ENGINE_STATS``).

* ``TINY_RG`` (RG-LRU, RG-LRU, sliding attention; GELU FFN): the
  conformance suite's recurrent grid (``tests/test_serve_conformance.py``:
  prefill_chunk 8 / 64 / None, reversed and staggered admission at
  decode_block 4), so the conv tail and the LRU state carry across chunk
  boundaries and ride along in mixed ticks;
* ``TINY_SWA`` (window 16, prompts up to 31 tokens so the rings wrap) and
  ``TINY_LG`` (4 layers, local/global pattern 1, window 16: two local and
  two global segments) with A^3 off and conservative: A^3 and its
  re-sorts run on the global segments only;
* ``TINY_MOE`` (a dense layer 0, then MoE layers with one shared expert)
  at pipeline_depth 0 and 1, and the same weights with zero routers: a
  full tie, so every token picks experts 0 and 1, and a 64-token chunk
  over 4 lanes (256 tokens, capacity 192) drops a quarter of the
  choices. Capacity is taken by every token of a dispatch, pad positions
  and idle lanes included, so both engines must route the same rows;
* the port's CLI on the CPU for the smoke variant of each new family.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.config import A3Config, MoEConfig  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

from test_torch_helpers import TINY, TINY_LG, TINY_RG, TINY_SWA, \
    assert_engine_invariants, assert_same_stats, drive, jax_blocks_ready, \
    port_a3, port_cfg  # noqa: E402

torch.set_num_threads(1)

MAX_LEN = 96
MAX_NEW = 6
PROMPT_LENS = (5, 12, 23, 31, 9)
TINY_MOE = dataclasses.replace(
    TINY, name="tiny-moe", family="moe", num_layers=3,
    moe=MoEConfig(num_experts=4, num_shared=1, top_k=2, d_expert=32,
                  num_dense_layers=1))
CONFIGS = {"rglru": (TINY_RG, 1), "swa": (TINY_SWA, 1), "lg": (TINY_LG, 1),
           "moe": (TINY_MOE, 4), "moe-tie": (TINY_MOE, 4)}


@functools.lru_cache(maxsize=None)
def _models(name):
    cfg, seed = CONFIGS[name]
    params = jdec.init_params(jax.random.PRNGKey(seed), cfg)
    if name == "moe-tie":                  # seg1: the MoE layers
        moe = params["seg1"]["moe"]
        params["seg1"]["moe"] = {**moe, "router": moe["router"] * 0}
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                              port_cfg(cfg), device="cpu")
    return cfg, params, model


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, TINY.vocab_size, size=n) for n in PROMPT_LENS]


def _both(name, prompts, *, a3="off", order="upfront", **kw):
    cfg, params, model = _models(name)
    a3c = A3Config() if a3 == "off" else A3Config.conservative()
    kw = {"slots": 4, "max_len": MAX_LEN, "resort_every": 2, **kw}
    ref = JaxEngine(params, cfg, a3=a3c, **kw)
    port = ServeEngine(model, port_cfg(cfg), a3=port_a3(a3c), **kw)
    want, _ = drive(ref, prompts, order=order, max_new=MAX_NEW)
    got, _ = drive(port, prompts, order=order, max_new=MAX_NEW)
    assert got == want
    assert all(r is not None and len(r) == MAX_NEW for r in got.values())
    assert_same_stats(port, ref)
    assert_engine_invariants(port)
    return got, port


# ---------------------------------------------------------------------------
# the recurrent grid (TINY_RG)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [8, 64, None])
def test_rglru_engine_matches_jax_engine(prompts, chunk):
    """Chunk 8 puts boundaries mid-prompt (the 23- and 31-token prompts
    wrap the 24-row ring too); 64 and None admit each prompt whole."""
    _both("rglru", prompts[:3], slots=2, prefill_chunk=chunk)


@pytest.mark.parametrize("order", ["reversed", "staggered"])
def test_rglru_admission_order_matches_jax_engine(prompts, order):
    """Mixed ticks: decoding lanes ride the prefill dispatch at length 0,
    prefilling lanes ride the decode block at pos -1."""
    got, _ = _both("rglru", prompts[:3], slots=2, prefill_chunk=8,
                   order=order, decode_block=4)
    up, _ = _both("rglru", prompts[:3], slots=2, prefill_chunk=8,
                  decode_block=4)
    assert got == up


def test_rglru_pad_lanes_stay_bit_identical(prompts):
    """After a serve, the slot that never held a request keeps its
    initial state bit for bit: it rode every dispatch as a pad lane."""
    _, eng = _both("rglru", prompts[:2], slots=3, prefill_chunk=8,
                   decode_block=4)
    n = 0
    for sc in eng.cache.values():
        for leaf in sc.values():
            assert not torch.any(leaf[:, 2] != 0)
            assert torch.any(leaf[:, 0] != 0)
            n += 1
    assert n == 4          # h, conv of the RG-LRU pair; k, v of the ring


# ---------------------------------------------------------------------------
# windowed attention (TINY_SWA, TINY_LG)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["swa", "lg"])
@pytest.mark.parametrize("a3", ["off", "conservative"])
@pytest.mark.parametrize("chunk,decode_block", [(8, 4), (None, 1)])
def test_windowed_engine_matches_jax_engine(prompts, name, a3, chunk,
                                            decode_block):
    """Rings of 16 rows that the 23- and 31-token prompts wrap; on the
    local/global config A^3 and its re-sorts touch the global segments
    only (``resorts`` counts them per segment, as the reference does)."""
    _, eng = _both(name, prompts, a3=a3, prefill_chunk=chunk,
                   decode_block=decode_block)
    n_global = sum(1 for sc in eng.cache.values() if "sk_vals" in sc)
    if a3 == "off" or name == "swa":
        assert n_global == 0 and eng.stats["resorts"] == 0
    else:
        assert n_global == 2 and eng.stats["resorts"] > 0


# ---------------------------------------------------------------------------
# Mixture-of-Experts (TINY_MOE)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["moe", "moe-tie"])
@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("chunk,decode_block", [(8, 4), (64, 1)])
def test_moe_engine_matches_jax_engine(prompts, name, depth, chunk,
                                       decode_block):
    """Ragged chunks and idle decode lanes route through the experts
    with the live tokens; at depth 1 the harvests land a block late."""
    with jax_blocks_ready():
        _both(name, prompts, prefill_chunk=chunk,
              decode_block=decode_block, pipeline_depth=depth)


def test_moe_tie_drops_choices_at_chunk_64():
    """The tied router's 64-token chunk over 4 lanes overflows: experts
    0 and 1 each get 256 choices for 192 slots, so 128 of the 512
    choices of a prefill dispatch go to the overflow bin."""
    from repro_torch.models.moe import moe_route
    cfg, _, model = _models("moe-tie")
    blk = model.segs[1].layers[0]
    x = torch.randn((4 * 64, cfg.d_model), generator=torch.Generator()
                    .manual_seed(0))
    r = moe_route(blk.moe, x, port_cfg(cfg).moe)
    assert r["cap"] == 192
    assert (r["top_e"] == torch.tensor([0, 1])).all()
    assert int((~r["keep"]).sum()) == 128


# ---------------------------------------------------------------------------
# the CLI on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma3-4b", "recurrentgemma-2b",
                                  "deepseek-moe-16b", "h2o-danube-1.8b"])
def test_cli_smoke_runs_on_cpu(capsys, arch):
    from repro_torch.launch.serve import main
    main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
          "--slots", "2", "--prompt-len", "20", "--max-new", "4",
          "--a3", "conservative", "--decode-block", "2"])
    out = capsys.readouterr().out
    assert f"arch={arch} a3=conservative requests=3/3" in out
    assert "new_tokens=12" in out
