"""Int8 prefix-cache pools and int8 A^3 scoring of the port against the
JAX package: the cases of ``tests/test_kv_quant.py`` that need no
hypothesis (its seed-drawn property skips without it) and no batched
``a3_attention``.

* **Selection**: int8-scored ``select_candidates`` (per-column scales
  folded into the query) picks JAX's masks on the pinned seeds, within
  one boundary swap of float scoring; with power-of-two scales it is
  bit-identical to selection over the dequantized columns.
* **Pool**: recorded from the same cache, the port's int8 pages, page
  scales and sorted-key snapshots (values, column scales, rows) are
  bit-equal to JAX's, and so is the restored cache; from the port's own
  prefill, a restored ring is within the per-page quantization bound of
  a cold prefill (recurrent carries exact).
* **Engine**: the int8-pool engine gives the JAX int8 engine's tokens,
  counters and trie on the warm-equals-cold grid (TINY, TINY_RG,
  TINY_XL, TINY_SWA, TINY_LG; A^3 off and conservative; pipeline_depth
  0 and 1), int8-warm tokens equal fp-warm tokens on the reference's
  fixed seeds, ``kv_quant="none"`` is the default engine, and the knob
  is validated.
* **Compact op**: ``a3_decode_attention_compact`` with int8 sorted
  columns, K and V (``sk_scale``, ``k_scale``, ``v_scale``) against
  JAX's at the tolerances of the port's other compact tests.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import A3Config, ServeConfig as JaxServeConfig  # noqa: E402
from repro.core import candidate_selection as jcs  # noqa: E402
from repro.core.quantization import quantize_int8_block as jquant  # noqa: E402,E501
from repro.kernels.decode_attention import ops as jops  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro.serve.prefix_cache import PrefixCache as JaxPrefixCache  # noqa: E402,E501
from repro_torch.config import ServeConfig  # noqa: E402
from repro_torch.core import candidate_selection as tcs  # noqa: E402
from repro_torch.core.quantization import dequantize_int8_block, \
    quantize_int8_block  # noqa: E402
from repro_torch.kernels.decode_attention import ops as tops  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.prefix_cache import PrefixCache  # noqa: E402

from test_torch_helpers import F32_TOL, N, T, TINY, cache_to_torch, \
    port_a3, port_cfg  # noqa: E402
from test_torch_prefix_cache import CONFIGS, MAX_LEN, PAGE, \
    _both, _models, _serve, _shared_prefix_prompts  # noqa: E402

torch.set_num_threads(1)


def _bits(x) -> np.ndarray:
    """Raw bytes of a torch tensor or jax array, for bit equality."""
    a = N(x) if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(a).view(np.uint8)


def _assert_tree_bit_equal(port, ref):
    assert set(port) == set(ref)
    for key, want in ref.items():
        if isinstance(want, dict):
            _assert_tree_bit_equal(port[key], want)
        else:
            np.testing.assert_array_equal(_bits(port[key]), _bits(want),
                                          err_msg=str(key))


# ---------------------------------------------------------------------------
# int8-scored candidate selection
# ---------------------------------------------------------------------------

def _selection(seed, s=128, d=16, m=32):
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(s, d)).astype(np.float32)
    q = rng.normal(size=(d,)).astype(np.float32)
    jsk = jcs.sort_key_columns(jnp.asarray(k))
    jq, jscales = jcs.quantize_sorted_keys(jsk)
    want, _ = jcs.select_candidates(jq, jnp.asarray(q), m, scales=jscales)
    sk = tcs.sort_key_columns(T(k))
    skq, scales = tcs.quantize_sorted_keys(sk)
    assert skq.values.dtype == torch.int8 and scales.shape == (d,)
    np.testing.assert_array_equal(_bits(skq.values), _bits(jq.values))
    np.testing.assert_array_equal(_bits(scales), _bits(jscales))
    fp, _ = tcs.select_candidates(sk, T(q), m)
    qm, _ = tcs.select_candidates(skq, T(q), m, scales=scales)
    np.testing.assert_array_equal(N(qm), np.asarray(want))
    return int((fp & qm).sum()), min(int(fp.sum()), int(qm.sum()))


def test_int8_selection_overlap_fixed_seeds():
    """JAX's int8 masks on every seed of the pinned sweep, within one
    boundary swap of float scoring."""
    for seed in range(24):
        overlap, nsel = _selection(seed)
        assert overlap >= nsel - 1, (seed, overlap, nsel)


def test_int8_selection_pow2_scale_exact():
    rng = np.random.default_rng(5)
    s, d, m = 96, 8, 24
    k = T(rng.normal(size=(s, d)).astype(np.float32))
    q = T(rng.normal(size=(d,)).astype(np.float32))
    sk = tcs.sort_key_columns(k)
    amax = sk.values.abs().amax(0)
    scales = 2.0 ** torch.ceil(torch.log2(torch.clamp(amax / 127.0,
                                                      min=1e-12)))
    qv = torch.clamp(torch.round(sk.values / scales), -127, 127).to(
        torch.int8)
    m_q, g_q = tcs.select_candidates(tcs.SortedKeys(qv, sk.rows), q, m,
                                     scales=scales)
    m_d, g_d = tcs.select_candidates(
        tcs.SortedKeys(dequantize_int8_block(qv, scales), sk.rows), q, m)
    assert torch.equal(m_q, m_d)
    assert torch.equal(g_q, g_d)


# ---------------------------------------------------------------------------
# pool: int8 record and gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axes,shape", [((2, 3), (2, 3, 8, 16)),
                                        ((2,), (2, 3, 24, 16))],
                         ids=["page", "sorted-columns"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_block_quantizer_bit_equal_on_the_page_layout(axes, shape,
                                                           dtype):
    """``quantize_int8_block`` on the pool's layouts, ``[L, H, ps, hd]``
    per page and ``[L, H, w, d]`` per sorted column, with half-way
    values (round half to even) and zero blocks: int8 values and float32
    scales bit-equal to JAX's, eager against the division and, as the
    pool quantizes, jitted against ``reciprocal=True`` (XLA compiles
    ``amax / 127`` to ``amax * float32(1/127)``)."""
    rng = np.random.default_rng(len(shape) + len(axes))
    x = rng.normal(size=shape).astype(np.float32)
    x[0, 0] = 0.0
    x[1, 1, 0] = 127.0
    x[1, 1, 1:] = np.arange(x[1, 1, 1:].size).reshape(x[1, 1, 1:].shape) \
        * 0.5 - 40.25
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else
                     jnp.float32)
    for jit, reciprocal in ((False, False), (True, True)):
        fn = jax.jit(jquant, static_argnums=1) if jit else jquant
        jq, js = fn(jx, axes)
        q, s = quantize_int8_block(T(np.asarray(jx)), axes=axes,
                                   reciprocal=reciprocal)
        np.testing.assert_array_equal(_bits(q), _bits(jq))
        np.testing.assert_array_equal(_bits(s), _bits(js))


@functools.lru_cache(maxsize=None)
def _jax_chunk(name, a3):
    cfg = CONFIGS[name][0]
    return jax.jit(lambda p, c, t, pos, n, srt: jdec.prefill_chunk(
        p, cfg, c, t, pos, n, a3=a3, sort_lanes=srt))


def _record_both(name, a3, kv_quant, p):
    """Prefill ``p`` into lane 0 of a JAX cache in 8-token chunks
    (sorting on the final one) and record every boundary into a JAX
    prefix cache and, from the same cache converted, into the port's
    -> (JAX cache, port cache, JAX pc, port pc)."""
    cfg, params, _ = _models(name)
    kw = dict(max_len=MAX_LEN, page_size=PAGE, cache_pages=64, a3=a3,
              kv_quant=kv_quant)
    jpc = JaxPrefixCache(cfg, **kw)
    tpc = PrefixCache(port_cfg(cfg), device="cpu", **kw)
    jc = jdec.init_cache(cfg, 2, MAX_LEN, a3=a3)
    jnode, tnode = jpc.root, tpc.root
    for cur in range(0, len(p), PAGE):
        take = min(PAGE, len(p) - cur)
        toks = np.zeros((2, PAGE), np.int32)
        toks[0, :take] = p[cur:cur + take]
        _, jc = _jax_chunk(name, a3)(
            params, jc, jnp.asarray(toks), jnp.asarray([cur, 0], jnp.int32),
            jnp.asarray([take, 0], jnp.int32),
            jnp.asarray([cur + take >= len(p), False]))
        if (cur + take) % PAGE == 0:
            tc = cache_to_torch(jc)
            jnode = jpc.record_boundary(jc, 0, p, cur + take, jnode)
            tnode = tpc.record_boundary(tc, 0, p, cur + take, tnode)
    tc = cache_to_torch(jc)
    jpc.record_final(jc, 0, jnode, len(p))
    tpc.record_final(tc, 0, tnode, len(p))
    return jc, tc, jpc, tpc, tnode


@pytest.mark.parametrize("name,a3", [
    ("tiny", False), ("tiny", True), ("tiny-rg", False), ("tiny-lg", True),
    ("tiny-xl", False)])
def test_int8_record_and_gather_bit_equal_to_jax(name, a3):
    """The same cache recorded by both packages into int8 pools: pages,
    page scales and the A^3 leaf snapshot (int8 values, per-column
    scales, rows) bit-equal; the prefix then restored into lane 1 of a
    fresh cache: every leaf of the restored caches bit-equal."""
    p = np.random.default_rng(17).integers(0, 256, size=26)
    _, _, jpc, tpc, tnode = _record_both(name, a3, "int8", p)
    _assert_tree_bit_equal(tpc.pool, jpc.pool)
    for seg in tpc.pool.values():
        assert seg["k"].dtype == torch.int8
        assert seg["k_scale"].dtype == torch.float32
    if a3 and tpc._sk_widths:
        jleaf = next(n for n in jpc._nodes if n.sk_snap is not None)
        assert tnode.sk_snap is not None and tnode.end == jleaf.end
        assert tnode.sk_pages and len(tnode.sk_pages) == len(jleaf.sk_pages)
        _assert_tree_bit_equal(tnode.sk_snap, jleaf.sk_snap)
        assert all(h["vals"].dtype == torch.int8
                   for h in tnode.sk_snap.values())
    cfg = CONFIGS[name][0]
    got, t, _ = tpc.admit(tdec.init_cache(port_cfg(cfg), 2, MAX_LEN, a3=a3,
                                          device="cpu"), 1, p[:17])
    want, t_ref, _ = jpc.admit(jdec.init_cache(cfg, 2, MAX_LEN, a3=a3), 1,
                               p[:17])
    assert t == t_ref == 16
    _assert_tree_bit_equal(got, jax.tree_util.tree_map(np.asarray, want))


@pytest.mark.parametrize("name", ["tiny", "tiny-rg", "tiny-xl"])
def test_int8_pool_gather_within_quant_bound(name):
    """From the port's own prefill: the int8-restored ring of a 16-token
    prefix is within amax/250 of a cold chunked prefill (half a scale
    step per element); recurrent carries, snapshots and not pages, are
    exact."""
    cfg, _, model = _models(name)
    tcfg = port_cfg(cfg)
    p = np.random.default_rng(17).integers(0, 256, size=26)
    pc = PrefixCache(tcfg, max_len=MAX_LEN, page_size=PAGE, cache_pages=8,
                     kv_quant="int8", device="cpu")
    cache = tdec.init_cache(tcfg, 2, MAX_LEN, device="cpu")
    node = pc.root
    for cur in range(0, len(p), PAGE):
        take = min(PAGE, len(p) - cur)
        toks = np.zeros((2, PAGE), np.int32)
        toks[0, :take] = p[cur:cur + take]
        tdec.prefill_chunk(model, tcfg, cache, torch.as_tensor(toks),
                           [cur, 0], [take, 0])
        if (cur + take) % PAGE == 0:
            node = pc.record_boundary(cache, 0, p, cur + take, node)
    got, t, _ = pc.admit(tdec.init_cache(tcfg, 2, MAX_LEN, device="cpu"), 1,
                         p[:17])
    assert t == 16
    cold = tdec.init_cache(tcfg, 2, MAX_LEN, device="cpu")
    for cur in range(0, t, PAGE):
        toks = np.zeros((2, PAGE), np.int32)
        toks[1] = p[cur:cur + PAGE]
        tdec.prefill_chunk(model, tcfg, cold, torch.as_tensor(toks),
                           [0, cur], [0, PAGE])
    for seg, sc in cold.items():
        for leaf, want in sc.items():
            a, b = N(got[seg][leaf][:, 1]), N(want[:, 1])
            if leaf in ("k", "v"):
                bound = max(np.abs(b).max() / 250.0, 1e-6)
                assert np.abs(a - b).max() <= bound, (seg, leaf)
            else:
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6,
                                           err_msg=f"{seg}.{leaf}")


def test_int8_pool_doubles_residency_at_equal_hbm():
    nbytes = lambda pool: sum(  # noqa: E731
        t.numel() * t.element_size() for seg in pool.values()
        for t in seg.values())
    cfg = port_cfg(TINY)
    fp = tdec.init_page_pool(cfg, 32, PAGE, device="cpu")
    q8 = tdec.init_page_pool(cfg, 32, PAGE, kv_quant="int8", device="cpu")
    assert nbytes(fp) / nbytes(q8) >= 2.0
    assert int(nbytes(fp) / (nbytes(q8) / 32)) >= 2 * 32


# ---------------------------------------------------------------------------
# engine: the int8 pool against the JAX engine's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("a3", ["off", "conservative"])
@pytest.mark.parametrize("name", ["tiny", "tiny-rg", "tiny-xl", "tiny-swa",
                                  "tiny-lg"])
def test_int8_engine_matches_jax_engine(name, a3, depth):
    """The warm-equals-cold grid with an int8 pool: the JAX int8
    engine's tokens, counters and trie."""
    prompts = _shared_prefix_prompts(256)
    _, port, _ = _both(name, [prompts[:1], prompts[1:]], a3=a3, slots=2,
                       prefill_chunk=PAGE, page_size=PAGE, cache_pages=32,
                       kv_quant="int8", resort_every=2, pipeline_depth=depth)
    assert port.stats["prefix_tokens_reused"] == 24 * (len(prompts) - 1)


@pytest.mark.parametrize("name,a3", [
    ("tiny", "off"), ("tiny-rg", "off"), ("tiny-xl", "off"),
    ("tiny", "conservative")], ids=["attention", "rglru", "xlstm", "a3"])
def test_int8_warm_matches_fp_warm_fixed_seeds(name, a3):
    """The reference's bar on its fixed seeds, on the port: int8-warm
    tokens equal fp-warm tokens, with the same prefix reuse (each pool
    is held against the JAX engine's on these prompts by
    ``test_int8_engine_matches_jax_engine`` and the prefix-cache grid)."""
    cfg, _, model = _models(name)
    prompts = _shared_prefix_prompts(256)
    outs, reused = [], []
    for kv_quant in ("none", "int8"):
        eng = ServeEngine(model, port_cfg(cfg), a3=port_a3(
            A3Config() if a3 == "off" else A3Config.conservative()),
            slots=2, max_len=MAX_LEN, prefill_chunk=PAGE, page_size=PAGE,
            cache_pages=32, kv_quant=kv_quant)
        outs.append(_serve(eng, [prompts[:1], prompts[1:]]))
        assert eng.stats["prefix_hits"] == len(prompts) - 1
        reused.append(eng.stats["prefix_tokens_reused"])
    assert outs[0] == outs[1]
    assert reused[0] == reused[1]


def test_kv_quant_none_is_default_engine():
    _, _, model = _models("tiny")
    cfg = port_cfg(TINY)
    kw = dict(slots=2, max_len=MAX_LEN, prefill_chunk=PAGE, page_size=PAGE,
              cache_pages=32)
    base = ServeEngine(model, cfg, **kw)
    none = ServeEngine(model, cfg, kv_quant="none", **kw)
    dtypes = lambda e: {s: {k: t.dtype for k, t in d.items()}  # noqa: E731
                        for s, d in e._pc.pool.items()}
    assert dtypes(base) == dtypes(none)
    prompts = _shared_prefix_prompts(256)
    assert _serve(base, [prompts]) == _serve(none, [prompts])


def test_kv_quant_validation():
    with pytest.raises(ValueError, match="kv_quant"):
        ServeConfig(kv_quant="fp8")
    with pytest.raises(ValueError, match="kv_quant"):
        JaxServeConfig(kv_quant="fp8")
    with pytest.raises(ValueError, match="kv_quant"):
        PrefixCache(port_cfg(TINY), max_len=MAX_LEN, page_size=PAGE,
                    cache_pages=4, kv_quant="int4", device="cpu")
    with pytest.raises(ValueError, match="kv_quant"):
        ServeEngine(_models("tiny")[2], port_cfg(TINY), kv_quant="bogus")
    assert ServeConfig().kv_quant == "none"
    assert ServeConfig(kv_quant="int8", cache_pages=8).kv_quant == "int8"


# ---------------------------------------------------------------------------
# the compact op with int8 sorted columns, K and V
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("integer", [True, False])
def test_compact_int8_matches_jax(integer, shards):
    """Int8 sorted columns (one scale per block and column) and int8 K/V
    (one scale per row) through both compact ops: outputs within 2e-5,
    as the port's float compact tests hold them; and, on the reference's
    gaussian draws, within 0.1 of the float path (on the tie-heavy
    integer keys the int8 columns may select other rows)."""
    rng = np.random.default_rng(2 + shards)
    b, hq, hkv, d, s = 2, 4, 2, 16, 128
    if integer:
        q = rng.integers(-2, 3, size=(b, hq, d)).astype(np.float32) * 4
        k = rng.integers(-3, 4, size=(b, hkv, s, d)).astype(np.float32)
    else:
        q = rng.normal(size=(b, hq, d)).astype(np.float32)
        k = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    valid = np.ones((b, s), bool)
    valid[0, 100:] = False
    cfg = dataclasses.replace(A3Config.conservative(), select_shards=shards)
    sl = s // shards
    jsk = jax.vmap(jax.vmap(jax.vmap(jcs.sort_key_columns)))(
        jnp.asarray(k).reshape(b, hkv, shards, sl, d))
    jqv, jsks = jquant(jsk.values, axes=(3,))
    jkq, jks = jquant(jnp.asarray(k), axes=(3,))
    jvq, jvs = jquant(jnp.asarray(v), axes=(3,))
    want = jops.a3_decode_attention_compact(
        jnp.asarray(q), jkq, jvq, jnp.asarray(valid), cfg,
        jcs.SortedKeys(jqv.reshape(b, hkv, s, d),
                       jsk.rows.reshape(b, hkv, s, d)),
        sk_scale=jsks.reshape(b, hkv, shards, d), k_scale=jks[..., 0],
        v_scale=jvs[..., 0])
    tsk = tcs.sort_key_columns(T(k).reshape(b, hkv, shards, sl, d))
    qv, sks = quantize_int8_block(tsk.values, axes=(3,))
    kq, ks = quantize_int8_block(T(k), axes=(3,))
    vq, vs = quantize_int8_block(T(v), axes=(3,))
    got = tops.a3_decode_attention_compact(
        T(q), kq, vq, T(valid), port_a3(cfg),
        tcs.SortedKeys(qv.reshape(b, hkv, s, d),
                       tsk.rows.reshape(b, hkv, s, d)),
        sk_scale=sks.reshape(b, hkv, shards, d), k_scale=ks[..., 0],
        v_scale=vs[..., 0])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(N(got), np.asarray(want), **F32_TOL)
    fp = tops.a3_decode_attention_compact(
        T(q), T(k), T(v), T(valid), port_a3(cfg),
        tcs.SortedKeys(tsk.values.reshape(b, hkv, s, d),
                       tsk.rows.reshape(b, hkv, s, d)))
    if not integer:             # the reference's gaussian draws
        assert float((fp - got).abs().max()) < 0.1
