"""A^3 block-sparse attention (kernels #5, #6 and the public op) of the
port vs the JAX package.

- The block-map helpers (``build_block_map``, ``block_map_to_mask``,
  ``union_block_map_gqa``) and ``candidate_block_map_for_heads`` must give
  exactly the reference's maps — in float32, in bfloat16 (the bf16
  ``q * scale`` and bf16 products of the selection) and on int8 keys with
  ``k_scale``.
- The plain versions of the row-max and attend kernels are held against
  ``a3_sparse_attention(interpret=True)``, with per-kv-head and unioned
  per-query-head maps, and the public ``a3_attention`` in modes OFF,
  conservative and aggressive against the JAX op's kernel path, at 2e-5
  (f32) / 2e-2 (bf16).
- The CUDA kernels run only on a card (``gpu`` marker). JAX is imported
  inside the ``jx`` fixture only, so ``pytest -m gpu --noconftest`` runs
  on a machine without JAX.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import A3Config, A3Mode  # noqa: E402
from repro_torch.kernels.a3_attention import kernel as tak  # noqa: E402
from repro_torch.kernels.a3_attention import ops as tops  # noqa: E402
from repro_torch.kernels.a3_attention.ref import \
    a3_sparse_attention_ref  # noqa: E402

from test_torch_helpers import N, assert_nan_and_zero_rows, cuda, \
    tol  # noqa: E402,F401

torch.set_num_threads(1)

DTYPES = ["float32", "bfloat16"]
# 32-row blocks make the candidate maps sparse at these small lengths
SMALL_BLOCKS = dict(block_q=32, block_k=32)
MODES = {
    "off": A3Config(),
    "conservative": A3Config.conservative(),
    "aggressive": A3Config.aggressive(),
    "aggressive_b32": dataclasses.replace(A3Config.aggressive(),
                                          **SMALL_BLOCKS),
}


@pytest.fixture(scope="module")
def jx():
    """The JAX package's A^3 kernels, helpers, oracle and public op."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro import config as jcfg
    from repro.core.quantization import quantize_int8_block
    from repro.kernels.a3_attention import kernel as jk
    from repro.kernels.a3_attention import ops as jops
    from repro.kernels.a3_attention.ref import a3_sparse_attention_ref as jref

    def a3(cfg: A3Config):
        kw = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(jcfg.A3Config)}
        kw["mode"] = jcfg.A3Mode(cfg.mode.value)
        return jcfg.A3Config(**kw)

    # jit: one compile instead of the eager vmap-of-scan dispatch
    block_map = jax.jit(jops.candidate_block_map_for_heads, static_argnums=2)

    def op(q, k, v, cfg, k_scale=None, v_scale=None, window=None):
        fn = jax.jit(lambda q, k, v, ks, vs: jops.a3_attention(
            q, k, v, a3(cfg), causal=True, window=window, k_scale=ks,
            v_scale=vs, use_kernel=True, interpret=True))
        return fn(q, k, v, k_scale, v_scale)

    return SimpleNamespace(jnp=jnp, k=jk, ops=jops, ref=jref, a3=a3,
                           quant=quantize_int8_block, block_map=block_map,
                           op=op)


def _qkv(seed, b, hq, hkv, s, d, dtype, dv=None):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(sh).astype(np.float32)
            for sh in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, dv or d))]
    return arrs, [torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in arrs]


def _clustered(seed, b, hq, hkv, s, d, dtype, block=32, n_clusters=4):
    """Keys around one of ``n_clusters`` centres chosen by position
    (block by block), each query near the centre of its own position:
    the recipe of ``benchmarks/bench_kernels.py::_clustered`` laid out so
    that the candidate block maps come out sparse."""
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((b, hkv, n_clusters, d))
    assign = (np.arange(s) // block) % n_clusters
    k = cents[:, :, assign] + 0.15 * rng.standard_normal((b, hkv, s, d))
    q = np.repeat(cents[:, :, assign], hq // hkv, axis=1) \
        + 0.3 * rng.standard_normal((b, hq, s, d))
    v = rng.standard_normal((b, hkv, s, d))
    arrs = [a.astype(np.float32) for a in (q, k, v)]
    return arrs, [torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in arrs]


def _jax(jx, arrs, dtype):
    return [jx.jnp.asarray(a, getattr(jx.jnp, dtype)) for a in arrs]


def _random_map(seed, b, h, nq, nk, density):
    """Random [B,H,nq,nk] block mask with the diagonal kept live."""
    rng = np.random.default_rng(seed)
    bm = rng.random((b, h, nq, nk)) < density
    return bm | np.eye(nq, nk, dtype=bool)[None, None]


def _maps_equal(got, want):
    for g, w in zip(got, want):
        assert N(g).dtype == np.int32
        np.testing.assert_array_equal(N(g), np.asarray(w))


# ---------------------------------------------------------------------------
# block-map helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_blocks", [None, 3])
def test_build_block_map_equal(jx, max_blocks):
    bm = _random_map(1, 2, 3, 4, 8, 0.4)
    bm[0, 0, 1] = False                              # an empty row
    want = jx.k.build_block_map(jx.jnp.asarray(bm), max_blocks)
    got = tak.build_block_map(torch.from_numpy(bm), max_blocks)
    _maps_equal(got, want)


def test_block_map_to_mask_and_union_equal(jx):
    bm = _random_map(2, 2, 6, 4, 4, 0.4)
    idx, cnt = jx.k.build_block_map(jx.jnp.asarray(bm))
    tidx, tcnt = tak.build_block_map(torch.from_numpy(bm))
    np.testing.assert_array_equal(N(tak.block_map_to_mask(tidx, tcnt, 4)),
                                  np.asarray(jx.k.block_map_to_mask(
                                      idx, cnt, 4)))
    np.testing.assert_array_equal(N(tak.block_map_to_mask(tidx, tcnt, 4)),
                                  bm)
    for group in (2, 3):
        _maps_equal(tak.union_block_map_gqa(tidx, tcnt, group, 4),
                    jx.k.union_block_map_gqa(idx, cnt, group, 4))


# ---------------------------------------------------------------------------
# kernels #5 / #6: plain versions vs Pallas interpret
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("threshold", [None, 3.0])
@pytest.mark.parametrize("density", [0.25, 1.0])
def test_sparse_plain_matches_pallas(jx, density, threshold, dtype):
    """tests/test_kernels.py::test_a3_sparse_sweep's shape."""
    arrs, (tq, tk_, tv) = _qkv(int(density * 10) + int(threshold or 0),
                               1, 2, 1, 512, 32, dtype)
    bm = _random_map(int(density * 100), 1, 2, 4, 4, density)
    idx, cnt = jx.k.build_block_map(jx.jnp.asarray(bm))
    ref = jx.k.a3_sparse_attention(*_jax(jx, arrs, dtype), idx, cnt,
                                   threshold=threshold, causal=True,
                                   interpret=True)
    tidx, tcnt = tak.build_block_map(torch.from_numpy(bm))
    out = tak.a3_sparse_attention(tq, tk_, tv, tidx, tcnt,
                                  threshold=threshold, causal=True)
    assert out.dtype == tq.dtype
    np.testing.assert_allclose(N(out), N(ref), **tol(dtype))


@pytest.mark.parametrize("group,threshold", [(2, None), (4, 2.0)])
def test_sparse_gqa_maps_match_pallas(jx, group, threshold):
    """Per-query-head maps (unioned inside) and pre-unioned per-kv-head
    maps, against the Pallas kernel; the row max against the dense masked
    max of the f32 scores."""
    b, hkv, s, d = 2, 2, 256, 32
    hq = hkv * group
    arrs, tt = _qkv(group * 10 + int(threshold or 0), b, hq, hkv, s, d,
                    "float32")
    bm = _random_map(group, b, hq, 2, 2, 0.5)
    idx, cnt = jx.k.build_block_map(jx.jnp.asarray(bm))
    ref = jx.k.a3_sparse_attention(*_jax(jx, arrs, "float32"), idx, cnt,
                                   threshold=threshold, causal=True,
                                   interpret=True)
    tidx, tcnt = tak.build_block_map(torch.from_numpy(bm))
    out_hq = tak.a3_sparse_attention(*tt, tidx, tcnt, threshold=threshold)
    np.testing.assert_allclose(N(out_hq), N(ref), **tol("float32"))
    kidx, kcnt = tak.union_block_map_gqa(tidx, tcnt, group, 2)
    out_kv = tak.a3_sparse_attention(*tt, kidx, kcnt, threshold=threshold)
    np.testing.assert_allclose(N(out_kv), N(ref), **tol("float32"))

    rm = tak.sparse_rowmax(tt[0], tt[1], kidx, kcnt)
    assert tuple(rm.shape) == (b, hkv, group, s)
    live = tak.block_map_to_mask(kidx, kcnt, 2).repeat_interleave(group, 1)
    elem = live.repeat_interleave(128, 2).repeat_interleave(128, 3)
    elem &= torch.ones(s, s, dtype=torch.bool).tril()
    sc = torch.einsum("bhqd,bhkd->bhqk", tt[0],
                      tt[1].repeat_interleave(group, 1)) * d ** -0.5
    want = torch.where(elem, sc, -1e30).amax(-1).reshape(b, hkv, group, s)
    np.testing.assert_allclose(N(rm), N(want), **tol("float32"))


def test_sparse_small_blocks_and_window_match_pallas(jx, window=96):
    """32-row blocks (each a partial 64-column tile of the kernel), a
    sliding window, and a row max of -1e30 for rows with nothing
    admitted."""
    arrs, tt = _qkv(7, 1, 6, 2, 256, 32, "float32")
    bm = _random_map(7, 1, 2, 8, 8, 0.3)
    bm[0, 1, 3] = False                               # q block 3: nothing
    idx, cnt = jx.k.build_block_map(jx.jnp.asarray(bm))
    ref = jx.k.a3_sparse_attention(*_jax(jx, arrs, "float32"), idx, cnt,
                                   threshold=2.0, window=window,
                                   interpret=True, **SMALL_BLOCKS)
    tidx, tcnt = tak.build_block_map(torch.from_numpy(bm))
    out = tak.a3_sparse_attention(*tt, tidx, tcnt, threshold=2.0,
                                  window=window, **SMALL_BLOCKS)
    np.testing.assert_allclose(N(out), N(ref), **tol("float32"))
    assert float(N(out)[0, 3:6, 96:128].__abs__().max()) == 0.0
    rm = tak.sparse_rowmax(tt[0], tt[1], tidx, tcnt, window=window,
                           **SMALL_BLOCKS)
    assert (N(rm)[0, 1, :, 96:128] == np.float32(-1e30)).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("threshold", [None, 2.0])
def test_sparse_plain_head_dim_256_matches_pallas(jx, threshold, dtype):
    """gemma3-4b's head dim (D = Dv = 256) at S = 256 with 128 x 128
    blocks, GQA 2: the plain versions of #5 and #6 against the Pallas
    kernels in interpret mode."""
    arrs, tt = _qkv(256 + int(threshold or 0), 1, 4, 2, 256, 256, dtype)
    bm = _random_map(256, 1, 2, 2, 2, 0.5)
    idx, cnt = jx.k.build_block_map(jx.jnp.asarray(bm))
    ref = jx.k.a3_sparse_attention(*_jax(jx, arrs, dtype), idx, cnt,
                                   threshold=threshold, causal=True,
                                   interpret=True)
    tidx, tcnt = tak.build_block_map(torch.from_numpy(bm))
    out = tak.a3_sparse_attention(*tt, tidx, tcnt, threshold=threshold)
    assert tuple(out.shape) == (1, 4, 256, 256) and out.dtype == tt[0].dtype
    np.testing.assert_allclose(N(out), N(ref), **tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_sparse_ref_matches_jax_ref(jx, dtype):
    arrs, tt = _qkv(4, 1, 4, 2, 256, 32, dtype)
    bm = _random_map(4, 1, 2, 2, 2, 0.5)              # per kv head
    idx, cnt = jx.k.build_block_map(jx.jnp.asarray(bm))
    ref = jx.ref(*_jax(jx, arrs, dtype), idx, cnt, threshold=3.0,
                 window=200)
    tidx, tcnt = tak.build_block_map(torch.from_numpy(bm))
    out = a3_sparse_attention_ref(*tt, tidx, tcnt, threshold=3.0,
                                  window=200)
    np.testing.assert_allclose(N(out), N(ref), **tol(dtype))


def test_cpu_route_is_plain_and_counts_launched():
    _, tt = _qkv(1, 1, 2, 1, 256, 32, "float32")
    tidx, tcnt = tak.build_block_map(torch.ones(1, 1, 2, 2, dtype=torch.bool))
    before = dict(tak.LAUNCHES)
    rm = tak.sparse_rowmax(tt[0], tt[1], tidx, tcnt)
    assert torch.equal(rm, tak.sparse_rowmax_plain(tt[0], tt[1], tidx, tcnt))
    out = tak.sparse_attend(*tt, tidx, tcnt, rm, threshold=1.0)
    assert torch.equal(out, tak.sparse_attend_plain(*tt, tidx, tcnt, rm,
                                                    threshold=1.0))
    assert tak.LAUNCHES == before


def test_wrapper_rejects_bad_maps():
    _, tt = _qkv(1, 1, 2, 1, 256, 32, "float32")
    tidx, tcnt = tak.build_block_map(torch.ones(1, 1, 2, 2, dtype=torch.bool))
    with pytest.raises(ValueError, match="int32"):
        tak.sparse_rowmax(tt[0], tt[1], tidx.long(), tcnt)
    with pytest.raises(ValueError, match="kv_indices"):
        tak.sparse_rowmax(tt[0], tt[1], tidx[:, :, :1], tcnt)


# ---------------------------------------------------------------------------
# candidate block maps and the public op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,dtype", [("conservative", "bfloat16"),
                                        ("aggressive_b32", "float32"),
                                        ("aggressive_b32", "bfloat16")])
def test_candidate_block_map_equal(jx, mode, dtype):
    """Exactly the reference's (kv_indices, kv_counts), f32 and bf16, on
    clustered keys whose maps are sparse at 32-row blocks."""
    arrs, (tq, tk_, _) = _clustered(11, 1, 4, 2, 256, 32, dtype)
    q, k, _ = _jax(jx, arrs, dtype)
    cfg = MODES[mode]
    want = jx.block_map(q, k, jx.a3(cfg))
    got = tops.candidate_block_map_for_heads(tq, tk_, cfg)
    _maps_equal(got, want)
    if mode == "aggressive_b32":
        assert int(N(got[1]).sum()) < N(got[1]).size * 8 // 2


def test_candidate_block_map_int8_keys_equal(jx):
    """int8 keys with per-(batch, kv head, column) scales folded into the
    query: the same map as the reference."""
    arrs, (tq, tk_, _) = _clustered(12, 2, 4, 2, 128, 16, "float32")
    kq, ks = jx.quant(jx.jnp.asarray(arrs[1]), axes=(2,))
    cfg = dataclasses.replace(A3Config.conservative(), **SMALL_BLOCKS)
    want = jx.block_map(jx.jnp.asarray(arrs[0]), kq, jx.a3(cfg),
                        ks[:, :, 0])
    got = tops.candidate_block_map_for_heads(
        tq, torch.from_numpy(np.array(kq)), cfg,
        k_scale=torch.from_numpy(np.array(ks[:, :, 0])))
    _maps_equal(got, want)


@pytest.mark.parametrize("mode", ["off", "conservative", "aggressive_b32"])
def test_a3_attention_matches_jax(jx, mode):
    """The public op in every mode against the JAX op's kernel path
    (Pallas in interpret mode)."""
    arrs, tt = _clustered(13, 1, 4, 2, 256, 32, "float32")
    cfg = MODES[mode]
    ref = jx.op(*_jax(jx, arrs, "float32"), cfg)
    out = tops.a3_attention(*tt, cfg, causal=True)
    np.testing.assert_allclose(N(out), N(ref), **tol("float32"))


def test_a3_attention_bf16_matches_jax(jx):
    arrs, tt = _clustered(14, 1, 4, 2, 256, 32, "bfloat16")
    cfg = MODES["aggressive_b32"]
    ref = jx.op(*_jax(jx, arrs, "bfloat16"), cfg)
    out = tops.a3_attention(*tt, cfg)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(N(out), N(ref), **tol("bfloat16"))


@pytest.mark.parametrize("mode", ["off", "conservative"])
def test_a3_attention_int8_kv_matches_jax(jx, mode):
    """tests/test_kv_quant.py::test_batch_a3_attention_int8_close_to_fp's
    shapes: int8 K/V with scales; selection scores the int8 keys, the
    softmax kernels see the dequantized values."""
    rng = np.random.default_rng(4)
    b, hq, hkv, d, s = 2, 4, 2, 16, 64
    q = rng.normal(size=(b, hq, s, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    kq, ks = jx.quant(jx.jnp.asarray(k), axes=(2,))
    vq, vs = jx.quant(jx.jnp.asarray(v), axes=(2,))
    cfg = MODES[mode]
    ref = jx.op(jx.jnp.asarray(q), kq, vq, cfg, ks[:, :, 0], vs[:, :, 0])
    tn = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    out = tops.a3_attention(tn(q), tn(kq), tn(vq), cfg,
                            k_scale=tn(ks[:, :, 0]), v_scale=tn(vs[:, :, 0]))
    np.testing.assert_allclose(N(out), N(ref), **tol("float32"))


def test_select_row_chunks_do_not_change_the_map(monkeypatch):
    """Chunking the selection's query rows bounds memory only."""
    from repro_torch.core import candidate_selection as tcs
    _, (tq, tk_, _) = _qkv(15, 1, 4, 2, 128, 16, "float32")
    cfg = MODES["aggressive_b32"]
    whole = tops.candidate_block_map_for_heads(tq, tk_, cfg)
    monkeypatch.setattr(tcs, "SELECT_CHUNK_ELEMS", 1)    # one row a chunk
    for g, w in zip(tops.candidate_block_map_for_heads(tq, tk_, cfg), whole):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("threshold", [None, 3.0])
def test_cuda_sparse_kernels_match_plain(cuda, threshold, dtype):
    """On the card: kernels #5 and #6 vs their plain versions at
    phi4-mini's attention width (Hq=24, Hkv=8, S=2048, D=128) on a random
    per-query-head map of density 0.5 with the diagonal kept."""
    _, tt = _qkv(21, 1, 24, 8, 2048, 128, dtype)
    tq, tk_, tv = [t.to(cuda) for t in tt]
    bm = torch.from_numpy(_random_map(21, 1, 24, 16, 16, 0.5)).to(cuda)
    idx, cnt = tak.union_block_map_gqa(*tak.build_block_map(bm), 3, 16)
    rm = tak.sparse_rowmax(tq, tk_, idx, cnt)
    np.testing.assert_allclose(N(rm), N(tak.sparse_rowmax_plain(
        tq, tk_, idx, cnt)), **tol(dtype))
    out = tak.sparse_attend(tq, tk_, tv, idx, cnt, rm, threshold=threshold)
    want = tak.sparse_attend_plain(tq, tk_, tv, idx, cnt, rm,
                                   threshold=threshold)
    np.testing.assert_allclose(N(out), N(want), **tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["off", "conservative", "aggressive_b32"])
def test_cuda_a3_attention_matches_cpu(cuda, mode):
    """The public op on the card vs the same op on the CPU: identical
    block maps, outputs within 1e-4 (float32; summation order)."""
    _, tt = _qkv(22, 1, 6, 2, 512, 64, "float32")
    cfg = MODES[mode]
    want = tops.a3_attention(*tt, cfg)
    got = tops.a3_attention(*[t.to(cuda) for t in tt], cfg)
    if mode != "off":
        for g, w in zip(tops.candidate_block_map_for_heads(
                tt[0].to(cuda), tt[1].to(cuda), cfg),
                tops.candidate_block_map_for_heads(tt[0], tt[1], cfg)):
            assert torch.equal(g.cpu(), w)
    np.testing.assert_allclose(N(got), N(want), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the routes of the pair (#5 and #6)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,d,dv,bq,bk,aligned,want", [
    (torch.bfloat16, 128, 128, 128, 128, True, "wgmma"),
    (torch.bfloat16, 64, 64, 128, 128, True, "wgmma"),
    (torch.bfloat16, 32, 96, 128, 128, True, "wgmma"),
    (torch.bfloat16, 128, 128, 64, 128, True, "simt"),
    (torch.bfloat16, 128, 128, 128, 32, True, "simt"),
    (torch.bfloat16, 72, 72, 128, 128, True, "simt"),
    (torch.bfloat16, 128, 40, 128, 128, True, "simt"),
    (torch.bfloat16, 144, 144, 128, 128, True, "wgmma"),
    (torch.bfloat16, 192, 192, 128, 128, True, "wgmma"),
    (torch.bfloat16, 256, 256, 128, 128, True, "wgmma"),
    (torch.bfloat16, 256, 128, 128, 128, True, "wgmma"),
    (torch.bfloat16, 200, 200, 128, 128, True, "simt"),
    (torch.bfloat16, 256, 256, 64, 64, True, "simt"),
    (torch.bfloat16, 256, 256, 128, 128, False, "simt"),
    (torch.bfloat16, 128, 128, 128, 128, False, "simt"),
    (torch.float32, 128, 128, 128, 128, True, "simt"),
    (torch.float32, 256, 256, 128, 128, True, "simt"),
])
def test_attend_route_by_dtype_head_dims_and_blocks(dtype, d, dv, bq, bk,
                                                    aligned, want):
    """The route a CUDA call of the pair takes is a function of dtype,
    head dims, block sizes and alignment, decided before the launches;
    each kernel counts its launches per route."""
    assert tak.sparse_route(dtype, d, dv, bq, bk, aligned) == want
    assert set(tak.LAUNCHES) == {"a3_sparse_rowmax_wgmma",
                                 "a3_sparse_rowmax_simt",
                                 "a3_sparse_attend_wgmma",
                                 "a3_sparse_attend_simt"}


@pytest.fixture
def fake_launches(monkeypatch):
    """The wrappers' kernel route on CPU tensors with every C entry
    replaced by a no-op that reports success: what each wrapper would
    launch shows in ``LAUNCHES`` (the outputs are left unwritten)."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "route", lambda t: "kernel")
    monkeypatch.setattr(build, "entry", lambda *a: (lambda *x: 0))
    monkeypatch.setattr(build, "stream", lambda dev: 0)
    saved = dict(tak.LAUNCHES)
    tak.reset_launch_counts()
    yield
    tak.LAUNCHES.update(saved)


@pytest.mark.parametrize("dtype,d,dv,block,want", [
    ("bfloat16", 128, 128, 128, "wgmma"),
    ("bfloat16", 64, 32, 128, "wgmma"),
    ("bfloat16", 128, 72, 128, "simt"),      # #5 alone would take wgmma
    ("bfloat16", 128, 128, 64, "simt"),
    ("bfloat16", 256, 256, 128, "wgmma"),
    ("bfloat16", 192, 192, 128, "wgmma"),
    ("bfloat16", 256, 128, 128, "wgmma"),
    ("bfloat16", 128, 256, 128, "wgmma"),
    ("bfloat16", 256, 200, 128, "simt"),     # #5 alone would take wgmma
    ("bfloat16", 256, 256, 64, "simt"),
    ("float32", 128, 128, 128, "simt"),
    ("float32", 256, 256, 128, "simt"),
])
def test_pair_takes_one_route_for_both_passes(fake_launches, dtype, d, dv,
                                              block, want):
    """a3_sparse_attention decides the route once: #5 and #6 always run
    on the same engine (so they score q.k in the same order); bf16 head
    dims up to 256 go to the tensor cores, float32 and head dims that
    are not multiples of 16 to the CUDA-core kernels."""
    _, tt = _qkv(3, 1, 4, 2, 256, d, dtype, dv=dv)
    tidx, tcnt = tak.build_block_map(torch.ones(1, 2, 256 // block,
                                                256 // block,
                                                dtype=torch.bool))
    tak.a3_sparse_attention(*tt, tidx, tcnt, threshold=0.0, block_q=block,
                            block_k=block)
    assert tak.LAUNCHES == {name: int(name.endswith(want))
                            for name in tak.LAUNCHES}


@pytest.mark.parametrize("d,dv", [(128, 128), (256, 256), (64, 256),
                                  (256, 128)])
def test_pair_gives_rowmax_the_attend_value_dim(monkeypatch, fake_launches,
                                                d, dv):
    """On the tensor cores the kv tile follows (D, Dv) (64 keys where
    either is above 128), and #5 must score with #6's tile: the pair
    passes #6's Dv to #5's C entry (after D), a lone #5 its own D."""
    from repro_torch.kernels import build
    calls = []

    def entry(source, name, argtypes):
        def fn(*args):
            calls.append((name, args))
            return 0
        return fn

    monkeypatch.setattr(build, "entry", entry)
    _, tt = _qkv(3, 1, 4, 2, 256, d, "bfloat16", dv=dv)
    tidx, tcnt = tak.build_block_map(torch.ones(1, 2, 2, 2,
                                                dtype=torch.bool))
    tak.a3_sparse_attention(*tt, tidx, tcnt, threshold=3.0)
    tak.sparse_rowmax(tt[0], tt[1], tidx, tcnt)
    names = [name for name, _ in calls]
    assert names == ["a3_sparse_rowmax_wgmma", "a3_sparse_attend_wgmma",
                     "a3_sparse_rowmax_wgmma"]
    # (..., B, Hq, Hkv, Sq, Sk, D, Dv, maxb, ...) after the five pointers
    assert calls[0][1][5:13] == (1, 4, 2, 256, 256, d, dv, 2)
    assert calls[1][1][7:15] == (1, 4, 2, 256, 256, d, dv, 2)
    assert calls[2][1][10:12] == (d, d)


def test_rowmax_alone_routes_on_its_own_head_dim(fake_launches):
    """Called alone, #5 decides from (D, D); a route the call cannot take
    raises before any launch."""
    _, tt = _qkv(3, 1, 4, 2, 256, 128, "bfloat16")
    tidx, tcnt = tak.build_block_map(torch.ones(1, 2, 2, 2,
                                                dtype=torch.bool))
    tak.sparse_rowmax(tt[0], tt[1], tidx, tcnt)
    tak.sparse_rowmax(tt[0], tt[1], tidx, tcnt, route="simt")
    assert tak.LAUNCHES["a3_sparse_rowmax_wgmma"] == 1
    assert tak.LAUNCHES["a3_sparse_rowmax_simt"] == 1
    with pytest.raises(ValueError, match="route"):
        tak.sparse_rowmax(tt[0].float(), tt[1].float(), tidx, tcnt,
                          route="wgmma")
    with pytest.raises(ValueError, match="route"):
        tak.sparse_attend(*tt, tidx, tcnt, torch.zeros(1, 2, 2, 256),
                          route="cuda")
    assert sum(tak.LAUNCHES.values()) == 2


def _launched(**routes):
    """A LAUNCHES dict with the given counts and zeros elsewhere."""
    return {name: routes.get(name, 0) for name in tak.LAUNCHES}


def _attend_map(kind, b, hkv, nq, device):
    """kv_indices / kv_counts per kv head: "empty" (no live block),
    "full" (every block), or "random" (density 0.5) where q block 0 sees
    only the block above its diagonal (its rows keep nothing: l == 0) and
    q block 2 lists two dead ids (-1 and nq + 3) beside blocks 0 and 2."""
    if kind == "empty":
        bm = np.zeros((b, hkv, nq, nq), dtype=bool)
    elif kind == "full":
        bm = np.ones((b, hkv, nq, nq), dtype=bool)
    else:
        bm = _random_map(31, b, hkv, nq, nq, 0.5)
        bm[:, :, 0] = False
        bm[:, :, 0, 1] = True
    idx, cnt = tak.build_block_map(torch.from_numpy(bm))
    if kind == "random":
        idx[:, :, 2, :4] = torch.tensor([-1, 0, nq + 3, 2], dtype=torch.int32)
        cnt[:, :, 2] = 4
    return idx.to(device), cnt.to(device)


SPARSE_WGMMA_CASES = [(kind, g, window, thr)
                      for kind in ("empty", "full", "random")
                      for g in (1, 3, 8)
                      for window, thr in ((None, 3.0), (200, None))]


@pytest.mark.gpu
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("case", SPARSE_WGMMA_CASES, ids=str)
def test_cuda_sparse_attend_wgmma_route_matches_plain(cuda, case, d):
    """On the card: bf16 attend calls with 128 x 128 blocks take the
    tensor-core kernel and agree with the plain version on empty, full
    and random live lists (rows with l == 0, dead ids), GQA groups 1, 3
    and 8, a window, with and without a threshold; at D 256 on 64-key
    tiles, two a live block."""
    kind, g, window, thr = case
    b, hkv, s = 2, 2, 512
    _, tt = _qkv(40 + g, b, g * hkv, hkv, s, d, "bfloat16")
    tq, tk_, tv = [t.to(cuda) for t in tt]
    idx, cnt = _attend_map(kind, b, hkv, s // 128, cuda)
    rm = tak.sparse_rowmax(tq, tk_, idx, cnt, window=window)
    tak.reset_launch_counts()
    out = tak.sparse_attend(tq, tk_, tv, idx, cnt, rm, threshold=thr,
                            window=window)
    assert tak.LAUNCHES == _launched(a3_sparse_attend_wgmma=1)
    want = tak.sparse_attend_plain(tq, tk_, tv, idx, cnt, rm, threshold=thr,
                                   window=window)
    np.testing.assert_allclose(N(out), N(want), **tol("bfloat16"))
    if kind != "full":
        assert bool((out[:, :, :128] == 0).all())      # l == 0 -> 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d,block", [("float32", 128, 128),
                                           ("bfloat16", 72, 128),
                                           ("bfloat16", 128, 64),
                                           ("bfloat16", 256, 64),
                                           ("float32", 256, 128)])
def test_cuda_sparse_attend_simt_route_matches_plain(cuda, dtype, d, block):
    """On the card: float32, and bf16 at a head dim or block size the
    tensor-core route does not take, run the CUDA-core attend kernel (at
    D 256 with 16 value columns a thread)."""
    b, hkv, g, s = 1, 2, 3, 512
    _, tt = _qkv(50, b, g * hkv, hkv, s, d, dtype)
    tq, tk_, tv = [t.to(cuda) for t in tt]
    nq = s // block
    bm = torch.from_numpy(_random_map(51, b, hkv, nq, nq, 0.5)).to(cuda)
    idx, cnt = tak.build_block_map(bm)
    kw = dict(block_q=block, block_k=block)
    rm = tak.sparse_rowmax(tq, tk_, idx, cnt, **kw)
    tak.reset_launch_counts()
    out = tak.sparse_attend(tq, tk_, tv, idx, cnt, rm, threshold=3.0, **kw)
    assert tak.LAUNCHES == _launched(a3_sparse_attend_simt=1)
    want = tak.sparse_attend_plain(tq, tk_, tv, idx, cnt, rm, threshold=3.0,
                                   **kw)
    np.testing.assert_allclose(N(out), N(want), **tol(dtype))


# ---------------------------------------------------------------------------
# the row-max kernel's routes (#5), the pair at threshold 0, head dim 256
# ---------------------------------------------------------------------------

def _edge_map(kind, b, hkv, nq, nk, device):
    """kv_indices / kv_counts per kv head over nq q blocks and nk kv
    blocks (Sq <= Sk, queries at the end): "empty" (no live block),
    "random" (density 0.5, where q block 0 lists only the last kv block,
    which lies above its diagonal when Sq > 128, and the last q block
    lists two dead ids, -1 and nk + 3, beside blocks 0 and nk - 1), or
    "capped" (every block live but only 2 slots kept, with kv_counts
    still above maxb)."""
    if kind == "empty":
        idx, cnt = tak.build_block_map(
            torch.zeros(b, hkv, nq, nk, dtype=torch.bool))
    elif kind == "capped":
        idx, cnt = tak.build_block_map(
            torch.ones(b, hkv, nq, nk, dtype=torch.bool), 2)
        cnt[:] = nk + 1
    else:
        bm = _random_map(32, b, hkv, nq, nk, 0.5)
        bm[:, :, 0] = False
        bm[:, :, 0, nk - 1] = True
        idx, cnt = tak.build_block_map(torch.from_numpy(bm))
        idx[:, :, nq - 1, :4] = torch.tensor([-1, 0, nk + 3, nk - 1],
                                             dtype=torch.int32)
        cnt[:, :, nq - 1] = 4
    return idx.to(device), cnt.to(device)


ROWMAX_CASES = [(kind, g, sq, window)
                for kind in ("empty", "random", "capped")
                for g in (1, 3)
                for sq, window in ((512, None), (512, 200), (256, None))]


def _check_rowmax(cuda, dtype, d, block, case, route):
    kind, g, sq, window = case
    b, hkv, sk = 2, 2, 512
    _, tt = _qkv(60 + g, b, g * hkv, hkv, sk, d, dtype)
    tq, tk_ = tt[0][:, :, sk - sq:].contiguous().to(cuda), tt[1].to(cuda)
    idx, cnt = _edge_map(kind, b, hkv, sq // block, sk // block, cuda)
    kw = dict(window=window, block_q=block, block_k=block)
    tak.reset_launch_counts()
    rm = tak.sparse_rowmax(tq, tk_, idx, cnt, **kw)
    assert tak.LAUNCHES == _launched(**{f"a3_sparse_rowmax_{route}": 1})
    want = tak.sparse_rowmax_plain(tq, tk_, idx, cnt, **kw)
    np.testing.assert_allclose(N(rm), N(want), **tol(dtype))
    empty = want == tak.NEG_INF
    assert bool((rm[empty] == tak.NEG_INF).all())     # -1e30, never -inf
    if kind == "empty":
        assert bool(empty.all())


@pytest.mark.gpu
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("case", ROWMAX_CASES, ids=str)
def test_cuda_sparse_rowmax_wgmma_route_matches_plain(cuda, case, d):
    """On the card: bf16 row-max calls with 128 x 128 blocks take the
    tensor-core kernel and agree with the plain version on empty, random
    and capped live lists (rows with nothing admitted at -1e30, dead ids,
    kv_counts above maxb), GQA groups 1 and 3, a window and a 256-row
    continuation of a 512-key prefix; at D 256 each live block is two
    64-key tiles."""
    _check_rowmax(cuda, "bfloat16", d, 128, case, "wgmma")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d,block", [("float32", 128, 128),
                                           ("bfloat16", 72, 128),
                                           ("bfloat16", 128, 64),
                                           ("bfloat16", 256, 64),
                                           ("float32", 256, 128)])
@pytest.mark.parametrize("case", [c for c in ROWMAX_CASES if c[1] == 3],
                         ids=str)
def test_cuda_sparse_rowmax_simt_route_matches_plain(cuda, case, dtype, d,
                                                     block):
    """On the card: float32, and bf16 at a head dim or block size the
    tensor-core kernel does not take, run the CUDA-core row max, on the
    same edge cases."""
    _check_rowmax(cuda, dtype, d, block, case, "simt")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d,block", [
    ("bfloat16", 128, 128), ("float32", 128, 128), ("bfloat16", 256, 128),
    ("float32", 256, 128), ("bfloat16", 256, 64)])
def test_cuda_sparse_pair_threshold_zero_keeps_the_max(cuda, dtype, d,
                                                       block):
    """At threshold 0 pass 2 keeps exactly the entries equal to pass 1's
    row max, so every row that admits an entry keeps its maximum and
    returns a non-zero row (V at the argmax), as the reference does: the
    two passes must score q.k in the same order (bf16 at 128 x 128 blocks
    on the tensor cores, with 64-key tiles at D = 256; float32, and bf16
    at 64 x 64 blocks, on the CUDA cores). phi4-mini's attention width at
    S = 2048 (gemma3-4b's at D = 256), a random map of density 0.5 with
    the diagonal kept."""
    hq, hkv = (24, 8) if d == 128 else (8, 4)
    n = 2048 // block
    _, tt = _qkv(70 + d, 1, hq, hkv, 2048, d, dtype)
    tq, tk_, tv = [t.to(cuda) for t in tt]
    bm = torch.from_numpy(_random_map(70, 1, hq, n, n, 0.5)).to(cuda)
    idx, cnt = tak.union_block_map_gqa(*tak.build_block_map(bm),
                                       hq // hkv, n)
    kw = dict(block_q=block, block_k=block)
    tak.reset_launch_counts()
    out = tak.a3_sparse_attention(tq, tk_, tv, idx, cnt, threshold=0.0, **kw)
    route = "wgmma" if dtype == "bfloat16" and block == 128 else "simt"
    assert tak.LAUNCHES == _launched(**{f"a3_sparse_rowmax_{route}": 1,
                                        f"a3_sparse_attend_{route}": 1})
    admits = (tak.sparse_rowmax_plain(tq, tk_, idx, cnt, **kw)
              > tak.NEG_INF)
    admits = admits.reshape(1, hq, 2048)
    zero = (out == 0).all(-1)
    assert bool(admits.all())                 # the diagonal is live
    assert int((zero & admits).sum()) == 0, \
        f"{int((zero & admits).sum())} admitting rows came back as 0"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hq,hkv,s,window,threshold", [
    (8, 4, 512, None, 3.0),                  # gemma3-4b's attention width
    (8, 4, 512, 300, None),
    (10, 1, 2048, 2048, 3.0),                # recurrentgemma-2b's MQA
])
def test_cuda_sparse_head_dim_256_matches_plain(cuda, hq, hkv, s, window,
                                                threshold, dtype):
    """On the card: #5 and #6 at D = Dv = 256 agree with their plain
    versions (#6 given #5's row max, as the pair runs) on the route of
    their dtype: bf16 on the tensor cores (64-key tiles), float32 on the
    CUDA-core kernels."""
    _, tt = _qkv(80, 1, hq, hkv, s, 256, dtype)
    tq, tk_, tv = [t.to(cuda) for t in tt]
    idx, cnt = _edge_map("random", 1, hkv, s // 128, s // 128, cuda)
    tak.reset_launch_counts()
    rm = tak.sparse_rowmax(tq, tk_, idx, cnt, window=window)
    np.testing.assert_allclose(N(rm), N(tak.sparse_rowmax_plain(
        tq, tk_, idx, cnt, window=window)), **tol(dtype))
    out = tak.sparse_attend(tq, tk_, tv, idx, cnt, rm, threshold=threshold,
                            window=window)
    route = "wgmma" if dtype == "bfloat16" else "simt"
    assert tak.LAUNCHES == _launched(**{f"a3_sparse_rowmax_{route}": 1,
                                        f"a3_sparse_attend_{route}": 1})
    want = tak.sparse_attend_plain(tq, tk_, tv, idx, cnt, rm,
                                   threshold=threshold, window=window)
    assert tuple(out.shape) == (1, hq, s, 256)
    np.testing.assert_allclose(N(out), N(want), **tol(dtype))


# ---------------------------------------------------------------------------
# NaN keys through the pair (#5 row max, #6 attend)
# ---------------------------------------------------------------------------

NAN_KEY = 200                     # a key of block 1 at 128-row blocks


def _nan_qkv(seed, b, hq, hkv, s, d, dtype):
    """``_qkv`` with key ``NAN_KEY`` NaN in batch 1 (V finite); batch 0
    clean."""
    arrs, _ = _qkv(seed, b, hq, hkv, s, d, "float32")
    arrs[1][1, :, NAN_KEY] = np.nan
    return arrs, [torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in arrs]



@pytest.mark.parametrize("threshold", [None, 3.0])
def test_sparse_plain_propagates_nan_keys_as_pallas(jx, threshold):
    """#5's and #6's plain versions against the Pallas sparse kernels in
    interpret mode on a NaN key: every query that admits it (causally
    after it, in a live block) gets a NaN row max (``jnp.maximum``), so
    its row comes out NaN without a threshold and zero under one."""
    arrs, (tq, tk_, tv) = _nan_qkv(61, 2, 4, 2, 512, 32, "float32")
    bm = _random_map(61, 2, 4, 4, 4, 0.5)
    idx, cnt = jx.k.build_block_map(jx.jnp.asarray(bm))
    ref = jx.k.a3_sparse_attention(*_jax(jx, arrs, "float32"), idx, cnt,
                                   threshold=threshold, causal=True,
                                   interpret=True)
    tidx, tcnt = tak.build_block_map(torch.from_numpy(bm))
    out = tak.a3_sparse_attention(tq, tk_, tv, tidx, tcnt,
                                  threshold=threshold, causal=True)
    assert_nan_and_zero_rows(out, ref, 2e-5, 2e-5)
    kidx, kcnt = tak.union_block_map_gqa(tidx, tcnt, 2, 4)
    rm = N(tak.sparse_rowmax_plain(tq, tk_, kidx, kcnt)).reshape(2, 4, 512)
    poisoned = np.isnan(rm)
    assert poisoned[1].any() and not poisoned[0].any()
    assert not poisoned[1, :, :NAN_KEY].any()          # causally before it
    rows = N(out)[poisoned]
    assert (np.isnan(rows).all() if threshold is None
            else (rows == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("hq,hkv,d", [(24, 8, 128), (8, 4, 256)])
@pytest.mark.parametrize("threshold", [None, 3.0])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_sparse_nan_keys_match_plain(cuda, dtype, threshold, hq, hkv,
                                          d):
    """On the card, at phi4-mini's and gemma3-4b's attention widths
    (S=2048, D=128 and 256; bf16 takes the tensor-core routes, float32
    the CUDA-core ones): #5 and #6 on a NaN key give their plain
    versions' NaN and zero rows, the other rows within the tolerance."""
    _, tt = _nan_qkv(23, 2, hq, hkv, 2048, d, dtype)
    tq, tk_, tv = [t.to(cuda) for t in tt]
    bm = torch.from_numpy(_random_map(23, 2, hq, 16, 16, 0.5)).to(cuda)
    idx, cnt = tak.union_block_map_gqa(*tak.build_block_map(bm),
                                       hq // hkv, 16)
    tak.reset_launch_counts()
    rm = tak.sparse_rowmax(tq, tk_, idx, cnt)
    route = "wgmma" if dtype == "bfloat16" else "simt"
    assert tak.LAUNCHES == _launched(**{f"a3_sparse_rowmax_{route}": 1})
    want_rm = tak.sparse_rowmax_plain(tq, tk_, idx, cnt)
    assert_nan_and_zero_rows(rm[..., None], want_rm[..., None],
                              **tol(dtype))
    assert bool(torch.isnan(want_rm).any())
    out = tak.sparse_attend(tq, tk_, tv, idx, cnt, want_rm,
                            threshold=threshold)
    want = tak.sparse_attend_plain(tq, tk_, tv, idx, cnt, want_rm,
                                   threshold=threshold)
    assert_nan_and_zero_rows(out, want, **tol(dtype))
