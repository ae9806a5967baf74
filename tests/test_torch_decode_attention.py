"""Decode-attention kernels of the port vs the JAX package.

The plain versions of the three kernels (fused, row max, attend) are
held against the Pallas kernels run with ``interpret=True``, and the
torch oracle against ``decode_attention_ref``, at 2e-5 (f32) / 2e-2
(bf16). The CUDA kernels themselves run only on a card: the ``cuda``
fixture skips those cases here.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import kernel as tk  # noqa: E402
from repro_torch.kernels.decode_attention.ref import \
    decode_attention_ref  # noqa: E402

from test_torch_helpers import N, cuda, tol  # noqa: E402,F401

torch.set_num_threads(1)

T_CONS = -math.log(0.05)           # the conservative threshold, ~3.0 nats


@pytest.fixture(scope="module")
def jx():
    """The JAX package's decode-attention kernel and oracle."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.decode_attention.kernel import decode_attention
    from repro.kernels.decode_attention.ref import decode_attention_ref
    return SimpleNamespace(jnp=jnp, decode_attention=decode_attention,
                           ref=decode_attention_ref)


def _inputs(seed, b, hq, hkv, s, d, dtype):
    """numpy q, k, v (float32) and mask (with one empty row), and the
    same as torch tensors in ``dtype`` ("float32" | "bfloat16")."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    mask = rng.random((b, hq, s)) < 0.6
    mask[0, hq - 1] = False                      # a row with nothing kept
    tdt = getattr(torch, dtype)
    tt = [torch.from_numpy(a).to(tdt) for a in (q, k, v)] + \
        [torch.from_numpy(mask)]
    return (q, k, v, mask), tt


def _to_jax(jx, arrays, dtype):
    q, k, v, mask = arrays
    return [jx.jnp.asarray(a, getattr(jx.jnp, dtype)) for a in (q, k, v)] + \
        [jx.jnp.asarray(mask)]


DTYPES = ["float32", "bfloat16"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hq,hkv", [(2, 2), (6, 2)])      # G = 1, 3
@pytest.mark.parametrize("block_k", [128, 512])
@pytest.mark.parametrize("threshold", [None, T_CONS])
def test_fused_plain_matches_pallas(jx, threshold, block_k, hq, hkv, dtype):
    """The fused kernel's plain version == the Pallas fused kernel,
    including the running-max threshold at block_k < S and empty rows."""
    arrays, (tq, tk_, tv, tm) = _inputs(block_k + hq, 2, hq, hkv, 512, 32,
                                        dtype)
    q, k, v, m = _to_jax(jx, arrays, dtype)
    ref = jx.decode_attention(q, k, v, m, threshold=threshold,
                              block_k=block_k, interpret=True)
    out = tk.fused(tq, tk_, tv, tm, threshold=threshold, block_k=block_k)
    assert out.dtype == tq.dtype and tuple(out.shape) == tuple(ref.shape)
    np.testing.assert_allclose(N(out), N(ref), **tol(dtype))
    assert np.abs(N(out)[0, hq - 1]).max() == 0.0           # empty row


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block_k", [128, 512])
def test_two_pass_plain_matches_pallas(jx, block_k, dtype):
    """Row max (#2) then attend (#3) == Pallas ``exact_two_pass``; the
    row max itself == the masked max of the f32 scores."""
    arrays, (tq, tk_, tv, tm) = _inputs(7 + block_k, 2, 6, 2, 512, 32, dtype)
    q, k, v, m = _to_jax(jx, arrays, dtype)
    ref = jx.decode_attention(q, k, v, m, threshold=2.0, block_k=block_k,
                              interpret=True, exact_two_pass=True)
    out = tk.decode_attention_plain(tq, tk_, tv, tm, threshold=2.0,
                                    block_k=block_k, exact_two_pass=True)
    np.testing.assert_allclose(N(out), N(ref), **tol(dtype))
    rm = tk.rowmax(tq, tk_, tm, block_k=block_k)
    kq = tk_.float().repeat_interleave(3, dim=1)
    sc = torch.einsum("bhd,bhkd->bhk", tq.float(), kq) * 32 ** -0.5
    want = torch.where(tm, sc, -1e30).amax(-1)
    np.testing.assert_allclose(N(rm), N(want), **tol("float32"))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("threshold", [None, 3.0])
def test_ref_matches_jax_ref(jx, threshold, dtype):
    arrays, (tq, tk_, tv, tm) = _inputs(3, 2, 8, 2, 256, 32, dtype)
    q, k, v, m = _to_jax(jx, arrays, dtype)
    ref = jx.ref(q, k, v, m, threshold=threshold)
    out = decode_attention_ref(tq, tk_, tv, tm, threshold=threshold)
    np.testing.assert_allclose(N(out), N(ref), **tol(dtype))


def test_fused_at_one_tile_is_the_exact_rule():
    """With S <= block_k the running max is the final max, so the fused
    kernel keeps exactly the SSIV-D set (the reference oracle)."""
    _, (tq, tk_, tv, tm) = _inputs(11, 2, 6, 2, 256, 32, "float32")
    out = tk.fused(tq, tk_, tv, tm, threshold=T_CONS, block_k=512)
    ref = decode_attention_ref(tq, tk_, tv, tm, threshold=T_CONS)
    np.testing.assert_allclose(N(out), N(ref), **tol("float32"))


@pytest.mark.parametrize("two_pass", [False, True])
def test_cpu_route_is_plain_and_counts_no_launch(two_pass):
    """CPU tensors take the plain version; only kernel launches count."""
    _, (tq, tk_, tv, tm) = _inputs(5, 1, 4, 2, 128, 32, "float32")
    before = dict(tk.LAUNCHES)
    out = tk.decode_attention(tq, tk_, tv, tm, threshold=1.0,
                              exact_two_pass=two_pass)
    want = tk.decode_attention_plain(tq, tk_, tv, tm, threshold=1.0,
                                     exact_two_pass=two_pass)
    assert torch.equal(out, want)
    assert tk.LAUNCHES == before


def test_wrapper_rejects_bad_shapes():
    _, (tq, tk_, tv, tm) = _inputs(5, 1, 4, 2, 384, 32, "float32")
    with pytest.raises(ValueError, match="multiple of block_k"):
        tk.fused(tq, tk_, tv, tm, block_k=256)
    with pytest.raises(ValueError, match="mask"):
        tk.fused(tq, tk_, tv, tm[:, :2])


@pytest.mark.gpu
@pytest.mark.parametrize("threshold", [None, 3.0])
@pytest.mark.parametrize("block_k", [128, 512])
def test_cuda_kernels_match_plain(cuda, block_k, threshold):
    """On the card: kernels #1-#3 vs their plain versions at the serving
    shape (B=4, Hq=24, Hkv=8, S=512, D=128, bf16)."""
    _, tt = _inputs(block_k, 4, 24, 8, 512, 128, "bfloat16")
    tq, tk_, tv, tm = [t.to(cuda) for t in tt]
    out = tk.fused(tq, tk_, tv, tm, threshold=threshold, block_k=block_k)
    want = tk.fused_plain(tq, tk_, tv, tm, threshold=threshold,
                          block_k=block_k)
    np.testing.assert_allclose(N(out), N(want), **tol("bfloat16"))
    rm = tk.rowmax(tq, tk_, tm, block_k=block_k)
    np.testing.assert_allclose(N(rm), N(tk.rowmax_plain(
        tq, tk_, tm, block_k=block_k)), **tol("bfloat16"))
    out2 = tk.attend(tq, tk_, tv, tm, rm, threshold=threshold,
                     block_k=block_k)
    want2 = tk.attend_plain(tq, tk_, tv, tm, rm, threshold=threshold,
                            block_k=block_k)
    np.testing.assert_allclose(N(out2), N(want2), **tol("bfloat16"))


@pytest.mark.parametrize("s,block_k,want", [
    (512, 512, 4), (512, 128, 4), (2048, 512, 4), (256, 512, 4),
    (128, 128, 4), (96, 512, 3), (64, 512, 2), (64, 32, 1), (32, 512, 1),
    (16, 512, 1), (100, 512, 2), (512, 64, 2),
])
def test_cluster_size(s, block_k, want):
    """CTAs per (batch, kv head) of the fused kernel: as many as 4 while
    each keeps at least 32 keys of a tile, so a short ring shrinks it."""
    c = tk.cluster_size(s, block_k)
    assert c == want
    bk = min(block_k, s)
    assert bk % c == 0 and (c == 1 or bk // c >= tk.MIN_CLUSTER_KEYS)


def test_launch_checks_cover_both_head_dims():
    """The fused kernel's launch checks bound Dv as well as D."""
    from repro_torch.kernels import build
    _, (tq, tk_, tv, tm) = _inputs(5, 1, 4, 2, 64, 32, "float32")
    build.check_launch("decode_attention", (tq, tk_, tv), (tm,), (32, 256),
                       tk.MAX_HEAD_DIM)
    with pytest.raises(ValueError, match="head dims"):
        build.check_launch("decode_attention", (tq, tk_, tv), (tm,),
                           (32, 320), tk.MAX_HEAD_DIM)
    with pytest.raises(ValueError, match="contiguous"):
        build.check_launch("decode_attention", (tq, tk_, tv),
                           (tm[:, :, ::2],), (32, 32), tk.MAX_HEAD_DIM)


# (b, hq, hkv, s, d, dtype, block_k, threshold): G, D, S, dtype and tile
# edges of the cluster kernel
FUSED_CASES = [
    (2, 4, 4, 512, 128, "bfloat16", 512, None),    # G = 1
    (2, 16, 2, 512, 128, "bfloat16", 128, 3.0),    # G = 8, several tiles
    (2, 6, 2, 512, 256, "bfloat16", 512, 3.0),     # D = 256
    (2, 6, 2, 32, 64, "bfloat16", 512, None),      # S = 32: cluster of 1
    (2, 6, 2, 64, 64, "float32", 512, 3.0),        # S = 64: cluster of 2
    (1, 4, 2, 96, 16, "float32", 512, None),       # the TINY ring: 3
    (4, 24, 8, 512, 128, "float32", 512, None),    # float32
    (4, 24, 8, 512, 128, "bfloat16", 128, 3.0),    # threshold, 4 tiles
    (1, 6, 2, 128, 20, "bfloat16", 64, 3.0),       # rows not 16-B aligned
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", FUSED_CASES, ids=str)
def test_cuda_fused_cluster_matches_plain(cuda, case):
    """On the card: the cluster-split fused kernel vs its plain version;
    the all-masked row outputs 0."""
    b, hq, hkv, s, d, dtype, block_k, threshold = case
    _, tt = _inputs(s + d + hq, b, hq, hkv, s, d, dtype)
    tq, tk_, tv, tm = [t.to(cuda) for t in tt]
    before = tk.LAUNCHES["decode_attention_fused"]
    out = tk.fused(tq, tk_, tv, tm, threshold=threshold, block_k=block_k)
    assert tk.LAUNCHES["decode_attention_fused"] == before + 1
    want = tk.fused_plain(tq, tk_, tv, tm, threshold=threshold,
                          block_k=block_k)
    np.testing.assert_allclose(N(out), N(want), **tol(dtype))
    assert np.abs(N(out)[0, hq - 1]).max() == 0.0
