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


def _inputs(seed, b, hq, hkv, s, d, dtype, dv=None):
    """numpy q, k, v (float32) and mask (with one empty row), and the
    same as torch tensors in ``dtype`` ("float32" | "bfloat16")."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, dv or d)).astype(np.float32)
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
@pytest.mark.parametrize("block_k", [128, 512])
def test_two_pass_plain_threshold_zero_keeps_the_max(jx, block_k, dtype):
    """At threshold 0 pass 2 keeps exactly the entries equal to pass 1's
    row max: the plain pair, as the Pallas ``exact_two_pass`` kernels,
    returns every row whose mask admits an entry non-zero (V at the
    argmax) and equal to the reference."""
    arrays, (tq, tk_, tv, tm) = _inputs(17 + block_k, 2, 6, 2, 512, 32,
                                        dtype)
    q, k, v, m = _to_jax(jx, arrays, dtype)
    ref = N(jx.decode_attention(q, k, v, m, threshold=0.0, block_k=block_k,
                                interpret=True, exact_two_pass=True))
    out = N(tk.decode_attention_plain(tq, tk_, tv, tm, threshold=0.0,
                                      block_k=block_k, exact_two_pass=True))
    admits = N(tm).any(-1)
    assert admits.sum() == 2 * 6 - 1                 # one empty row
    assert (np.abs(ref).max(-1) > 0)[admits].all()
    assert (np.abs(out).max(-1) > 0)[admits].all()
    np.testing.assert_allclose(out, ref, **tol(dtype))


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


# the C entries' arguments, in order, as ``csrc/decode_attention.cu``
# declares them
C_ARGS = {
    "decode_attention_rowmax": (
        "q", "k", "mask", "rowmax", "is_bf16", "B", "Hq", "Hkv", "S", "D",
        "bk", "cluster", "kvec", "scale", "stream"),
    "decode_attention_attend": (
        "q", "k", "v", "mask", "rowmax", "out", "is_bf16", "B", "Hq", "Hkv",
        "S", "D", "Dv", "bk", "cluster", "kvec", "scale", "has_thr", "thr",
        "stream"),
}


@pytest.fixture
def c_calls(monkeypatch):
    """The wrappers' kernel route on CPU tensors with every C entry
    replaced by a recorder that reports success: the list fills with
    (entry, {argument: value}) per launch (outputs are left unwritten)."""
    from repro_torch.kernels import build
    calls = []

    def entry(source, name, argtypes):
        def call(*args):
            assert len(args) == len(argtypes) == len(C_ARGS[name])
            calls.append((name, dict(zip(C_ARGS[name], args))))
            return 0
        return call

    monkeypatch.setattr(build, "route", lambda t: "kernel")
    monkeypatch.setattr(build, "entry", entry)
    monkeypatch.setattr(build, "stream", lambda dev: 0)
    saved = dict(tk.LAUNCHES)
    yield calls
    tk.LAUNCHES.update(saved)


@pytest.mark.parametrize("block_k", [128, 512])
@pytest.mark.parametrize("s,want", [
    (4096, 4), (512, 4), (256, 4), (128, 4), (96, 3), (64, 2), (100, 2),
    (32, 1), (16, 1), (1, 1),
])
def test_two_pass_cluster_size(c_calls, s, want, block_k):
    """CTAs per (batch, kv head) of the two-pass kernels: as many as 4
    while each keeps a contiguous slice of at least 32 keys of the ring,
    whatever block_k; both wrappers pass that size to their entries."""
    c = tk.two_pass_cluster_size(s)
    assert c == want
    assert s % c == 0 and (c == 1 or s // c >= tk.MIN_CLUSTER_KEYS)
    _, (tq, tk_, tv, tm) = _inputs(5, 1, 4, 2, s, 16, "float32")
    tk.decode_attention(tq, tk_, tv, tm, threshold=3.0, block_k=block_k,
                        exact_two_pass=True)
    assert [(name, a["cluster"], a["bk"]) for name, a in c_calls] == [
        ("decode_attention_rowmax", c, min(block_k, s)),
        ("decode_attention_attend", c, min(block_k, s))]


def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts one element past a
    16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("dtype,d,dv,skew,want", [
    ("bfloat16", 128, 128, None, "vec"),
    ("bfloat16", 128, 128, "v", "vec"),      # V not 16-byte aligned
    ("bfloat16", 128, 33, None, "vec"),      # Dv odd
    ("float32", 64, 31, "v", "vec"),
    ("bfloat16", 128, 128, "k", "scalar"),   # K not 16-byte aligned
    ("bfloat16", 20, 32, None, "scalar"),    # K rows of 40 bytes
])
def test_two_pass_scoring_route_is_decided_from_k(c_calls, dtype, d, dv,
                                                  skew, want):
    """#2 and #3 get one scoring route, decided on the host from K's
    alignment and D alone: a V that is misaligned or has an odd Dv does
    not move #3 off the route #2 takes (so at threshold 0 no row can
    lose its own maximum)."""
    _, (tq, tk_, tv, tm) = _inputs(9, 1, 6, 2, 128, d, dtype, dv=dv)
    if skew == "v":
        tv = _misaligned(tv)
    if skew == "k":
        tk_ = _misaligned(tk_)
    assert tk.score_route(tk_) == want
    tk.decode_attention(tq, tk_, tv, tm, threshold=0.0, exact_two_pass=True)
    assert [a["kvec"] for _, a in c_calls] == [int(want == "vec")] * 2


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
    # groups whose accumulators leave the ring less than its 160 KB
    (4, 10, 1, 2048, 256, "bfloat16", 512, None),  # recurrentgemma-2b
    (1, 8, 1, 1024, 256, "float32", 512, 3.0),     # G = 8, D = 256
    (1, 16, 1, 4096, 256, "bfloat16", 512, None),  # G = 16: one slot
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


# (b, hq, hkv, s, d, dv, dtype, block_k, threshold, skew_v): G, S, D, Dv,
# dtype, block_k and alignment edges of the two-pass cluster kernels
TWO_PASS_CASES = [
    (2, 4, 4, 512, 128, 128, "bfloat16", 512, None, False),  # G = 1
    (4, 24, 8, 512, 128, 128, "bfloat16", 128, 3.0, False),  # serving, G = 3
    (2, 16, 2, 512, 64, 64, "float32", 128, 3.0, False),     # G = 8, D = 64
    (2, 6, 2, 4096, 128, 128, "bfloat16", 512, 3.0, False),  # long ring
    (1, 16, 2, 4096, 256, 256, "float32", 512, None, False),  # D = 256
    (1, 16, 1, 4096, 64, 64, "bfloat16", 128, 3.0, False),   # two windows
    (2, 6, 2, 64, 64, 64, "bfloat16", 512, None, False),     # cluster of 2
    (1, 3, 1, 16, 32, 32, "float32", 512, None, False),      # cluster of 1
    (2, 6, 2, 512, 128, 64, "bfloat16", 512, 3.0, False),    # Dv < D
    (2, 6, 2, 512, 64, 96, "float32", 128, None, False),     # Dv > D
    (2, 6, 2, 512, 128, 33, "bfloat16", 512, 3.0, False),    # Dv odd
    (2, 6, 2, 512, 128, 128, "bfloat16", 512, 3.0, True),    # V misaligned
    (1, 6, 2, 128, 20, 20, "bfloat16", 64, 3.0, False),      # K rows of 40 B
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", TWO_PASS_CASES, ids=str)
def test_cuda_two_pass_cluster_matches_plain(cuda, case):
    """On the card: the cluster-split row-max (#2) and attend (#3)
    kernels vs their plain versions (#3 given #2's row max, as the pair
    runs); one launch each; the all-masked row reads -1e30 and outputs
    0."""
    b, hq, hkv, s, d, dv, dtype, block_k, threshold, skew_v = case
    _, tt = _inputs(s + d + dv + hq, b, hq, hkv, s, d, dtype, dv=dv)
    tq, tk_, tv, tm = [t.to(cuda) for t in tt]
    if skew_v:
        buf = torch.empty(tv.numel() + 1, dtype=tv.dtype, device=cuda)
        tv = buf[1:].view(tv.shape).copy_(tv)
    before = dict(tk.LAUNCHES)
    rm = tk.rowmax(tq, tk_, tm, block_k=block_k)
    out = tk.attend(tq, tk_, tv, tm, rm, threshold=threshold,
                    block_k=block_k)
    assert tk.LAUNCHES["decode_attention_rowmax"] == \
        before["decode_attention_rowmax"] + 1
    assert tk.LAUNCHES["decode_attention_attend"] == \
        before["decode_attention_attend"] + 1
    np.testing.assert_allclose(
        N(rm), N(tk.rowmax_plain(tq, tk_, tm, block_k=block_k)),
        **tol(dtype))
    want = tk.attend_plain(tq, tk_, tv, tm, rm, threshold=threshold,
                           block_k=block_k)
    np.testing.assert_allclose(N(out), N(want), **tol(dtype))
    assert N(rm)[0, hq - 1] == np.float32(tk.NEG_INF)
    assert np.abs(N(out)[0, hq - 1]).max() == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("skew_v", [False, True])
@pytest.mark.parametrize("s", [512, 4096])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_two_pass_threshold_zero_keeps_the_max(cuda, dtype, s, skew_v):
    """On the card, at the serving width (B=4, Hq=24, Hkv=8, D=128): at
    threshold 0 #3 keeps exactly the entries equal to #2's row max, so
    every row whose mask admits an entry comes back non-zero; the two
    kernels score q.k into the same floats, also when V is not 16-byte
    aligned and K is."""
    _, tt = _inputs(s + 1, 4, 24, 8, s, 128, dtype)
    tq, tk_, tv, tm = [t.to(cuda) for t in tt]
    if skew_v:
        buf = torch.empty(tv.numel() + 1, dtype=tv.dtype, device=cuda)
        tv = buf[1:].view(tv.shape).copy_(tv)
    out = tk.attend(tq, tk_, tv, tm, tk.rowmax(tq, tk_, tm), threshold=0.0)
    admits = tm.any(-1)
    lost = int(((out == 0).all(-1) & admits).sum())
    assert lost == 0, f"{lost} of {int(admits.sum())} admitting rows are 0"
