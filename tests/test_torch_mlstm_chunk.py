"""Chunkwise mLSTM (kernel #7) of the port vs the JAX package.

The torch oracle ``mlstm_chunk_ref`` is held against the JAX oracle; the
plain version of the kernel against the Pallas kernel run with
``interpret=True`` on ``tests/test_mlstm_kernel.py``'s shapes and chunks
(2e-5 / 2e-4 in float32, 5e-2 with bf16 streams) and on
``tests/test_kernels.py``'s odd lengths (2e-4, the sequential-vs-chunked
tolerance there). The carried state, which the Pallas kernel does not
have, is held two ways: h of a continuation from the state after a
prefix equals the Pallas kernel's h over the whole sequence, and the
final (C, n, m) and the block output equal those of the JAX model's
``xlstm.mlstm_chunkwise`` started from the same state.

The CUDA kernel runs only on a card: the ``cuda`` fixture skips those
cases here. JAX is imported inside the ``jx`` fixture only, so
``pytest -m gpu --noconftest`` runs on a machine without JAX.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.mlstm_chunk import kernel as tmk  # noqa: E402
from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunk  # noqa: E402
from repro_torch.kernels.mlstm_chunk.ref import \
    mlstm_chunk_ref  # noqa: E402

from test_torch_helpers import N, cuda  # noqa: E402,F401

torch.set_num_threads(1)

F32 = dict(atol=2e-5, rtol=2e-4)          # tests/test_mlstm_kernel.py
BF16 = dict(atol=5e-2, rtol=5e-2)
SEQ = dict(atol=2e-4, rtol=2e-4)          # tests/test_kernels.py, mLSTM


@pytest.fixture(scope="module")
def jx():
    """The JAX package's chunk kernel, oracle and xLSTM model module."""
    jax = pytest.importorskip("jax")
    from repro.kernels.mlstm_chunk.kernel import mlstm_chunk_kernel
    from repro.kernels.mlstm_chunk.ref import mlstm_chunk_ref as jref
    from repro.models import xlstm
    return SimpleNamespace(jax=jax, jnp=jax.numpy, kernel=mlstm_chunk_kernel,
                           ref=jref, xl=xlstm)


def _inputs(seed, b, h, s, dk, dv, scale=0.5):
    """numpy float32 q, k, v [B,H,S,D*] and gates [B,H,S]: log_i normal,
    log_f a log-sigmoid around 2 (long memory), as the JAX tests."""
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((b, h, s, dk)).astype(np.float32) * scale
            for _ in range(2))
    v = rng.standard_normal((b, h, s, dv)).astype(np.float32) * scale
    li = rng.standard_normal((b, h, s)).astype(np.float32)
    lf = -np.logaddexp(0.0, -(rng.standard_normal((b, h, s)) + 2.0))
    return q, k, v, li, lf.astype(np.float32)


def _state(seed, b, h, dk, dv):
    """A random carried (C, n, m) state, float32."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, dk, dv)).astype(np.float32),
            rng.standard_normal((b, h, dk)).astype(np.float32),
            rng.standard_normal((b, h)).astype(np.float32))


def _t(arrs, dtype=torch.float32, device="cpu"):
    """numpy arrays -> torch; the first three (the streams) in ``dtype``,
    the gates and states float32."""
    return [torch.from_numpy(np.array(a)).to(device,
                                             dtype if i < 3 else None)
            for i, a in enumerate(arrs)]


def _pallas(jx, arrs, dtype="float32", **kw):
    jnp = jx.jnp
    q, k, v = (jnp.asarray(a, getattr(jnp, dtype)) for a in arrs[:3])
    return jx.kernel(q, k, v, jnp.asarray(arrs[3]), jnp.asarray(arrs[4]),
                     interpret=True, **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_matches_jax_ref(jx, dtype):
    arrs = _inputs(1, 2, 2, 24, 16, 8)
    jnp = jx.jnp
    want = jx.ref(*(jnp.asarray(a, getattr(jnp, dtype)) for a in arrs[:3]),
                  jnp.asarray(arrs[3]), jnp.asarray(arrs[4]), scale=0.25)
    got = mlstm_chunk_ref(*_t(arrs, getattr(torch, dtype)), scale=0.25)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(N(got), N(want),
                               **(F32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("shape", [
    (1, 1, 16, 8, 8), (2, 2, 32, 16, 16), (1, 3, 64, 32, 16),
])
@pytest.mark.parametrize("chunk", [8, 16])
def test_plain_matches_pallas(jx, shape, chunk):
    """tests/test_mlstm_kernel.py::test_kernel_matches_oracle's sweep: the
    plain version (zero state) against the Pallas kernel."""
    b, h, s, dk, dv = shape
    arrs = _inputs(sum(shape) + chunk, *shape)
    scale = 1.0 / math.sqrt(dk)
    want = _pallas(jx, arrs, chunk=chunk, scale=scale)
    got = tmk.mlstm_chunk_plain(*_t(arrs), chunk=chunk, scale=scale)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(N(got), N(want), **F32)
    np.testing.assert_allclose(N(got), N(mlstm_chunk_ref(*_t(arrs),
                                                         scale=scale)),
                               **F32)


def test_ops_bf16_streams_match_pallas(jx):
    """tests/test_mlstm_kernel.py::test_kernel_bf16_inputs: bf16 q/k/v,
    h cast back to bf16 by the public op."""
    arrs = _inputs(2, 2, 2, 32, 16, 16)
    want = _pallas(jx, arrs, "bfloat16", chunk=16, scale=0.25)
    got = mlstm_chunk(*_t(arrs, torch.bfloat16), chunk=16, scale=0.25)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(N(got), N(want), **BF16)


@pytest.mark.parametrize("h,s", [(8, 64), (4, 96), (4, 97), (8, 160),
                                 (8, 33)])
def test_plain_matches_pallas_odd_lengths(jx, h, s):
    """tests/test_kernels.py::test_kernel_family_matches_ref (mLSTM): one
    chunk of the whole odd length (chunk 512 > S)."""
    arrs = _inputs(s + h, 1, h, s, 32, 32, scale=1.0)
    want = _pallas(jx, arrs, chunk=512, scale=32 ** -0.5)
    got = tmk.mlstm_chunk_plain(*_t(arrs), chunk=512, scale=32 ** -0.5)
    np.testing.assert_allclose(N(got), N(want), **SEQ)


@pytest.mark.parametrize("s,chunk", [(20, 8), (37, 16)])
def test_short_last_chunk_is_the_padded_chunk(jx, s, chunk):
    """S not a multiple of the chunk: the plain version's short last
    chunk equals the Pallas kernel on the sequence padded the model's way
    (zero q/k/v, log_i -1e30, log_f 0)."""
    arrs = _inputs(s, 2, 2, s, 16, 8)
    pad = -s % chunk
    padded = [np.pad(a, [(0, 0), (0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 3),
                     constant_values=-1e30 if i == 3 else 0.0)
              for i, a in enumerate(arrs)]
    want = _pallas(jx, padded, chunk=chunk, scale=0.25)
    got = tmk.mlstm_chunk_plain(*_t(arrs), chunk=chunk, scale=0.25)
    np.testing.assert_allclose(N(got), N(want)[:, :, :s], **F32)


@pytest.mark.parametrize("s1,chunk", [(16, 8), (12, 8), (32, 16)])
def test_carried_state_continues_the_sequence(jx, s1, chunk):
    """h of the continuation from the state after a prefix (also at a
    split inside a chunk) equals the Pallas kernel's h over the whole
    sequence from the zero state."""
    arrs = _inputs(s1, 2, 3, 48, 16, 8)
    want = _pallas(jx, arrs, chunk=chunk, scale=0.25)
    pre = [t[:, :, :s1] for t in _t(arrs)]
    post = [t[:, :, s1:] for t in _t(arrs)]
    h1, st = tmk.mlstm_chunk_plain(*pre, chunk=chunk, scale=0.25,
                                   return_state=True)
    h2 = tmk.mlstm_chunk_plain(*post, chunk=chunk, scale=0.25, state=st)
    np.testing.assert_allclose(N(torch.cat([h1, h2], 2)), N(want), **SEQ)


@pytest.mark.parametrize("valid", [False, True])
@pytest.mark.parametrize("chunk", [8, 256])
def test_carried_state_matches_model_chunkwise(jx, chunk, valid):
    """From a random carried state, the plain version on the JAX model's
    own projections and gates gives the final (C, n, m) of
    ``xlstm.mlstm_chunkwise(state=...)``, and its h, put through the
    model's head-wise norm, output gate and w_out, the model's output.
    ``valid`` masks a ragged tail the model's way."""
    jax, jnp, X = jx.jax, jx.jnp, jx.xl
    b, s, d, h, dh = 2, 21, 64, 2, 16
    p = X.mlstm_init(jax.random.PRNGKey(4), d, h, dh, jnp.float32)
    x = jnp.asarray(np.random.default_rng(5).standard_normal((b, s, d))
                    * 0.5, jnp.float32)
    st0 = _state(6, b, h, dh, dh)
    vmask = np.arange(s)[None, :] < np.array([[s], [13]]) if valid else None
    out, st = X.mlstm_chunkwise(p, x, h, dh, chunk=chunk,
                                state=tuple(map(jnp.asarray, st0)),
                                valid=None if vmask is None
                                else jnp.asarray(vmask))

    def heads(w):
        return np.moveaxis(np.asarray(x @ p[w]).reshape(b, s, h, dh), 2, 1)

    li, lf = (np.moveaxis(np.asarray(g), 2, 1) for g in X._mlstm_gates(p, x))
    if vmask is not None:
        li = np.where(vmask[:, None], li, -1e30).astype(np.float32)
        lf = np.where(vmask[:, None], lf, 0.0).astype(np.float32)
    hs, got = tmk.mlstm_chunk_plain(
        *_t([heads("wq"), heads("wk"), heads("wv"), li, lf]), chunk=chunk,
        scale=1.0 / math.sqrt(dh),
        state=tuple(torch.from_numpy(a) for a in st0), return_state=True)
    for name, a, w in zip("Cnm", got, st):
        np.testing.assert_allclose(N(a), np.asarray(w), **SEQ, err_msg=name)
    hn = X._headwise_ln(jnp.asarray(N(hs)), p["ln_scale"][None, :, None, :])
    o = jax.nn.sigmoid(x @ p["w_o"])
    via_port = (jnp.moveaxis(hn, 1, 2).reshape(b, s, h * dh) * o) \
        @ p["w_out"]
    np.testing.assert_allclose(np.asarray(via_port), np.asarray(out), **SEQ)


def test_cpu_route_is_plain_and_counts_no_launch():
    tt = _t(_inputs(1, 1, 2, 20, 8, 8))
    before = dict(tmk.LAUNCHES)
    out = tmk.mlstm_chunk_kernel(*tt, chunk=8)
    assert torch.equal(out, tmk.mlstm_chunk_plain(*tt, chunk=8))
    assert tmk.LAUNCHES == before


def test_wrapper_rejects_bad_shapes():
    q, k, v, li, lf = _t(_inputs(1, 1, 2, 16, 8, 8))
    with pytest.raises(ValueError, match="shape mismatch"):
        tmk.mlstm_chunk_kernel(q, k[..., :4], v, li, lf)
    with pytest.raises(ValueError, match="gates"):
        tmk.mlstm_chunk_kernel(q, k, v, li[..., :8], lf)
    with pytest.raises(ValueError, match="state"):
        tmk.mlstm_chunk_kernel(q, k, v, li, lf, state=(
            torch.zeros(1, 2, 8, 8), torch.zeros(1, 2, 8), torch.zeros(2)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("b,h,s,dk,dv,chunk", [
    (2, 2, 100, 32, 32, 16),       # tile tails: L 16, S not a multiple
    (1, 3, 150, 48, 80, 64),       # Dk, Dv not multiples of 64
    (1, 2, 300, 256, 256, 256),    # xlstm-350m's head: full + short chunk
    (2, 1, 23, 16, 16, 256),       # one 23-token chunk (L = S)
])
def test_cuda_kernel_matches_plain(cuda, b, h, s, dk, dv, chunk, with_state,
                                   dtype):
    """On the card: kernel #7 vs its plain version, h and the final
    state, from the zero state and from a carried one."""
    arrs = _inputs(s + dk, b, h, s, dk, dv)
    tt = _t(arrs, getattr(torch, dtype), cuda)
    state = tuple(torch.from_numpy(a).to(cuda)
                  for a in _state(s, b, h, dk, dv)) if with_state else None
    kw = dict(chunk=chunk, scale=dk ** -0.5, state=state, return_state=True)
    before = tmk.launches()
    h_k, st_k = tmk.mlstm_chunk_kernel(*tt, **kw)
    assert tmk.launches() == before + 1
    h_p, st_p = tmk.mlstm_chunk_plain(*tt, **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(N(h_k), N(h_p), **SEQ)
    for name, a, w in zip("Cnm", st_k, st_p):
        np.testing.assert_allclose(N(a), N(w), **SEQ, err_msg=name)


# ---------------------------------------------------------------------------
# the tensor-core route (mlstm_chunk_wgmma)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,dk,dv,chunk_len,aligned,want", [
    (torch.bfloat16, 256, 256, 256, True, "mlstm_chunk_wgmma"),   # xlstm-350m
    (torch.bfloat16, 64, 64, 64, True, "mlstm_chunk_wgmma"),
    (torch.bfloat16, 128, 192, 128, True, "mlstm_chunk_wgmma"),
    (torch.bfloat16, 256, 256, 192, True, "mlstm_chunk_wgmma"),
    (torch.bfloat16, 256, 256, 100, True, "mlstm_chunk_simt"),    # L % 64
    (torch.bfloat16, 256, 256, 23, True, "mlstm_chunk_simt"),     # L = S < 64
    (torch.bfloat16, 48, 80, 64, True, "mlstm_chunk_simt"),       # not x64
    (torch.bfloat16, 256, 320, 256, True, "mlstm_chunk_simt"),    # Dv > 256
    (torch.bfloat16, 256, 256, 256, False, "mlstm_chunk_simt"),   # unaligned
    (torch.float32, 256, 256, 256, True, "mlstm_chunk_simt"),     # f32 streams
])
def test_kernel_route_by_dtype_head_dims_and_chunk(dtype, dk, dv, chunk_len,
                                                   aligned, want):
    """The route a CUDA call takes is a function of the streams' dtype,
    the head dims, the chunk length and alignment, decided before the
    launch."""
    assert tmk.kernel_route(dtype, dk, dv, chunk_len, aligned) == want
    assert set(tmk.LAUNCHES) == {"mlstm_chunk_wgmma", "mlstm_chunk_simt"}


@pytest.mark.parametrize("bh,dv,want", [(16, 256, 2), (1, 64, 2),
                                        (33, 128, 2), (34, 128, 1),
                                        (32, 256, 1)])
def test_t_split_fills_one_wave(bh, dv, want):
    """The tensor-core route doubles its grid (a pair of CTAs per chunk
    and value slice) only while 2 x B*H x Dv/64 CTAs fit the 132 SMs of
    an H100 in one wave: xlstm-350m's B*H = 16 at Dv = 256 runs 128."""
    assert tmk.t_split(bh, dv) == want


def _split(x):
    """float32 -> (hi, lo) bf16 values (as float32) with hi + lo ~= x."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _split3(x):
    """float32 -> (hi, mid + lo) from three bf16 values (as float32)."""
    hi, _ = _split(x)
    mid, lo = _split(x - hi)
    return hi, mid + lo


def _once(x):
    """One rounding to bf16 (the design the split replaces)."""
    return x.bfloat16().float(), torch.zeros_like(x)


def _split_bf16_emulation(q, k, v, log_i, log_f, *, chunk, scale, state,
                          split=_split, split_c=_split3):
    """The tensor-core route's arithmetic in torch: q.k^T of bf16 streams
    accumulated in float32; the decayed scores s and the state update's
    v * w_r split into bf16 hi + lo, the state C into hi + mid + lo,
    every product of two bf16 operands accumulated in float32; the
    gates, n, den and h in float32."""
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    C, n, m = (t.clone() for t in state)
    out = torch.empty((b, h, s, dv))
    for c0 in range(0, s, chunk):
        c1 = min(c0 + chunk, s)
        qc, kc, vc = (t[:, :, c0:c1].float() for t in (q, k, v))
        li = log_i[:, :, c0:c1]
        f_cum = torch.cumsum(log_f[:, :, c0:c1], -1)
        f_tot = f_cum[..., -1]
        dmat = f_cum[..., :, None] - f_cum[..., None, :] + li[..., None, :]
        causal = torch.ones((c1 - c0, c1 - c0), dtype=torch.bool).tril()
        dmat = torch.where(causal, dmat, -1e30)
        m_row = torch.maximum(dmat.amax(-1), f_cum + m[..., None])
        sc = (qc @ kc.transpose(-1, -2)) * scale * torch.exp(
            dmat - m_row[..., None])
        inter_w = torch.exp(f_cum + m[..., None] - m_row)
        s_hi, s_lo = split(sc)
        c_hi, c_lo = split_c(C)
        num = s_hi @ vc + s_lo @ vc + inter_w[..., None] * (qc @ c_hi
                                                            + qc @ c_lo)
        den = sc.sum(-1) + inter_w * torch.einsum("bhtk,bhk->bht", qc, n)
        den = torch.maximum(den.abs(), torch.exp(-m_row))
        out[:, :, c0:c1] = num / den[..., None]
        wr_log = f_tot[..., None] - f_cum + li
        m_new = torch.maximum(f_tot + m, wr_log.amax(-1))
        f_eff = torch.exp(f_tot + m - m_new)
        wr = scale * torch.exp(wr_log - m_new[..., None])
        vw_hi, vw_lo = split(vc * wr[..., None])
        C = f_eff[..., None, None] * C + kc.transpose(-1, -2) @ vw_hi \
            + kc.transpose(-1, -2) @ vw_lo
        n = f_eff[..., None] * n + (kc * wr[..., None]).sum(-2)
        m = m_new
    return out, (C, n, m)


@pytest.mark.parametrize("s,with_state", [(512, True), (300, False)])
def test_split_bf16_arithmetic_reaches_the_tolerance(s, with_state):
    """At xlstm-350m's heads (Dk = Dv = 256, chunk 256, bf16 streams)
    the tensor-core route's split-bf16 arithmetic stays within the
    2e-4 (atol + rtol) of kernel #7's check against the plain version,
    for h and the final (C, n, m); rounding s, C and v * w_r once to
    bf16 would not."""
    arrs = _inputs(s, 1, 2, s, 256, 256)
    tt = _t(arrs, torch.bfloat16)
    st = tuple(torch.from_numpy(a) for a in _state(s, 1, 2, 256, 256)) \
        if with_state else (torch.zeros(1, 2, 256, 256), torch.zeros(1, 2, 256),
                            torch.full((1, 2), -1e30))
    want, wst = tmk.mlstm_chunk_plain(*tt, chunk=256, scale=1 / 16,
                                      state=st, return_state=True)
    got, gst = _split_bf16_emulation(*tt, chunk=256, scale=1 / 16, state=st)
    np.testing.assert_allclose(N(got), N(want), **SEQ)
    for name, a, w in zip("Cnm", gst, wst):
        np.testing.assert_allclose(N(a), N(w), **SEQ, err_msg=name)
    once, _ = _split_bf16_emulation(*tt, chunk=256, scale=1 / 16, state=st,
                                    split=_once, split_c=_once)
    assert not torch.allclose(once, want, **SEQ)


def _cuda_state(kind, seed, b, h, dk, dv, device):
    """None (zero state), a random carried state, or a zero state whose
    m is -1e30 (the model's fresh lanes)."""
    if kind == "zero":
        return None
    if kind == "m0_neg":
        return (torch.zeros((b, h, dk, dv), device=device),
                torch.zeros((b, h, dk), device=device),
                torch.full((b, h), -1e30, device=device))
    return tuple(torch.from_numpy(a).to(device)
                 for a in _state(seed, b, h, dk, dv))


WGMMA_CASES = [(s, kind, d, bh, 256) for s, kind in ((2048, "zero"),
                                                     (512, "carried"),
                                                     (300, "zero"))
               for d in (64, 128, 256) for bh in ((1, 1), (4, 4))] + [
    (512, "m0_neg", 256, (4, 4), 256), (200, "carried", 192, (2, 1), 128),
    (2048, "carried", 256, (4, 4), 256),
    (512, "carried", 256, (4, 8), 256)]         # one CTA a slice (t_split 1)


@pytest.mark.gpu
@pytest.mark.parametrize("case", WGMMA_CASES, ids=str)
def test_cuda_wgmma_route_matches_plain(cuda, case):
    """On the card: bf16 streams at head dims the tensor-core route takes
    run on it and agree with the plain version (h and the final state)
    within 2e-4: S=2048 from the zero state and from a carried one,
    S=512 from a carried one, S=300 (a 44-row last chunk), a zero state
    with m = -1e30, chunk 128 with a 72-row last chunk, B*H 1 and 16
    (a pair of CTAs per value slice) and 32 (one CTA per slice)."""
    s, kind, d, (b, h), chunk = case
    arrs = _inputs(s + d + b, b, h, s, d, d)
    tt = _t(arrs, torch.bfloat16, cuda)
    state = _cuda_state(kind, s + d, b, h, d, d, cuda)
    kw = dict(chunk=chunk, scale=d ** -0.5, state=state, return_state=True)
    tmk.reset_launch_counts()
    h_k, st_k = tmk.mlstm_chunk_kernel(*tt, **kw)
    assert tmk.LAUNCHES == {"mlstm_chunk_wgmma": 1, "mlstm_chunk_simt": 0}
    h_p, st_p = tmk.mlstm_chunk_plain(*tt, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(h_k).all())
    np.testing.assert_allclose(N(h_k), N(h_p), **SEQ)
    for name, a, w in zip("Cnm", st_k, st_p):
        np.testing.assert_allclose(N(a), N(w), **SEQ, err_msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d,chunk", [("float32", 256, 256),
                                           ("bfloat16", 48, 256),
                                           ("bfloat16", 256, 100)])
def test_cuda_simt_route_matches_plain(cuda, dtype, d, chunk):
    """On the card: float32 streams, and bf16 at a head dim or chunk
    length the tensor-core route does not take, run the CUDA-core
    kernel."""
    arrs = _inputs(d + chunk, 2, 2, 300, d, d)
    tt = _t(arrs, getattr(torch, dtype), cuda)
    state = _cuda_state("carried", d, 2, 2, d, d, cuda)
    kw = dict(chunk=chunk, scale=d ** -0.5, state=state, return_state=True)
    tmk.reset_launch_counts()
    h_k, st_k = tmk.mlstm_chunk_kernel(*tt, **kw)
    assert tmk.LAUNCHES == {"mlstm_chunk_wgmma": 0, "mlstm_chunk_simt": 1}
    h_p, st_p = tmk.mlstm_chunk_plain(*tt, **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(N(h_k), N(h_p), **SEQ)
    for name, a, w in zip("Cnm", st_k, st_p):
        np.testing.assert_allclose(N(a), N(w), **SEQ, err_msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,b,h,s,dk,dv,chunk,route", [
    ("bfloat16", 4, 1, 2048, 256, 64, 256, "mlstm_chunk_wgmma"),
    ("bfloat16", 2, 2, 300, 256, 256, 256, "mlstm_chunk_wgmma"),
    ("float32", 2, 2, 300, 32, 16, 128, "mlstm_chunk_simt"),
    ("bfloat16", 1, 2, 150, 48, 80, 64, "mlstm_chunk_simt")])
def test_cuda_kernel_without_final_state_matches_plain(cuda, dtype, b, h, s,
                                                       dk, dv, chunk, route):
    """On the card: with no final state asked for, each route skips the
    last chunk's state update and its h still equals the plain version's
    (from a carried state), at one rank's share of xlstm-350m's heads on
    16 ranks (Dv 64), a short last chunk, and CUDA-core shapes."""
    arrs = _inputs(s + dv, b, h, s, dk, dv)
    tt = _t(arrs, getattr(torch, dtype), cuda)
    state = _cuda_state("carried", s + dk, b, h, dk, dv, cuda)
    kw = dict(chunk=chunk, scale=dk ** -0.5, state=state)
    tmk.reset_launch_counts()
    h_k = tmk.mlstm_chunk_kernel(*tt, **kw)
    assert tmk.LAUNCHES[route] == 1 and tmk.launches() == 1
    h_p = tmk.mlstm_chunk_plain(*tt, **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(N(h_k), N(h_p), **SEQ)


# ---------------------------------------------------------------------------
# MLSTMChunk: kernel #7 with a backward (training)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d,s", [("bfloat16", 256, 512),
                                       ("float32", 32, 100)])
def test_cuda_mlstm_chunk_function_forward_and_grads(cuda, dtype, d, s):
    """On the card: MLSTMChunk's forward is kernel #7's output (one
    launch), and its input gradients (the plain version recomputed in the
    backward, no launch) are within 2e-2 of the largest gradient of
    autograd through the plain version on the same inputs."""
    from repro_torch.models.xlstm import MLSTMChunk
    b, h, chunk = 2, 2, 256
    arrs = _inputs(d + s, b, h, s, d, d) + _state(d, b, h, d, d)
    tt = _t(arrs, getattr(torch, dtype), cuda)
    ins = [t.clone().requires_grad_() for t in tt]
    tmk.reset_launch_counts()
    h_f, C_f, n_f, m_f = MLSTMChunk.apply(*ins, chunk, d ** -0.5)
    assert tmk.launches() == 1
    h_k, st_k = tmk.mlstm_chunk_kernel(*tt[:5], chunk=chunk,
                                       scale=d ** -0.5,
                                       state=tuple(tt[5:]),
                                       return_state=True)
    assert torch.equal(h_f, h_k) and torch.equal(C_f, st_k[0])
    g = torch.Generator(device=cuda).manual_seed(0)
    w_h, w_c = (torch.randn(t.shape, generator=g, device=cuda)
                for t in (h_f, C_f))
    tmk.reset_launch_counts()
    got = torch.autograd.grad((h_f * w_h).sum() + (C_f * w_c).sum(), ins)
    assert tmk.launches() == 0
    ref = [t.clone().requires_grad_() for t in tt]
    h_p, (C_p, _, _) = tmk.mlstm_chunk_plain(
        *ref[:5], chunk=chunk, scale=d ** -0.5, state=tuple(ref[5:]),
        return_state=True)
    want = torch.autograd.grad((h_p * w_h).sum() + (C_p * w_c).sum(), ref)
    torch.cuda.synchronize()
    for name, a, w in zip(("q", "k", "v", "log_i", "log_f", "C", "n", "m"),
                          got, want):
        scale = float(w.float().abs().max())
        np.testing.assert_allclose(N(a), N(w), rtol=0,
                                   atol=2e-2 * max(scale, 1e-6),
                                   err_msg=name)


@pytest.mark.gpu
def test_cuda_serving_call_launches_as_before(cuda):
    """The serving path (no grad) through ``mlstm_chunkwise`` launches
    kernel #7 once per call on the route ``kernel_route`` picks, as
    before the autograd wrapper, and returns the kernel's numbers."""
    from repro_torch.models import xlstm as xl
    d_model, heads, hd, s = 512, 2, 256, 512
    p = xl.MLSTM(d_model, heads, hd, torch.bfloat16, cuda)
    xl.mlstm_init_(p, torch.Generator(device=cuda).manual_seed(0))
    p.requires_grad_(False)
    x = torch.randn((2, s, d_model), device=cuda).to(torch.bfloat16)
    tmk.reset_launch_counts()
    with torch.no_grad():
        out, state = xl.mlstm_chunkwise(p, x, heads, hd)
    assert tmk.LAUNCHES == {"mlstm_chunk_wgmma": 1, "mlstm_chunk_simt": 0}
    assert out.grad_fn is None and all(t.grad_fn is None for t in state)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out.float()).all())


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["tiny-xl", "xlstm-350m-width"])
def test_cuda_remat_dots_through_mlstm_chunk(cuda, arch):
    """On the card, ``remat="dots"`` (selective checkpointing over aten
    ops) around layers whose mLSTM runs kernel #7 through MLSTMChunk:
    the loss and every gradient equal ``remat="none"``'s (within 1e-4 of
    the largest gradient in float32, 2e-2 in bf16), every mLSTM parameter
    gets a finite non-zero gradient, and the forward launches #7. TINY_XL
    (float32, CUDA-core route, with its sLSTM layer) and two mLSTM layers
    at xlstm-350m's widths (bf16, tensor-core route)."""
    import dataclasses
    from repro_torch.config import BlockKind, get_arch
    from repro_torch.models import decoder as tdec
    from test_torch_helpers import TINY_XL, port_cfg
    if arch == "tiny-xl":
        cfg, b, s, tol = port_cfg(TINY_XL), 2, 40, 1e-4
    else:
        cfg = dataclasses.replace(get_arch("xlstm-350m"), num_layers=2,
                                  block_pattern=(BlockKind.MLSTM,))
        b, s, tol = 2, 512, 2e-2
    n_mlstm = sum(cfg.block_kind(i) == BlockKind.MLSTM
                  for i in range(cfg.num_layers))
    model = tdec.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                             cuda)
    model.requires_grad_(True)
    g = torch.Generator(device=cuda).manual_seed(1)
    toks, labels = (torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                                  device=cuda) for _ in range(2))
    params = dict(model.named_parameters())
    out = {}
    for remat in ("none", "dots"):
        tmk.reset_launch_counts()
        loss, _ = tdec.lm_loss(model, cfg, toks, labels, remat=remat)
        fwd = tmk.launches()
        grads = torch.autograd.grad(loss, list(params.values()))
        out[remat] = (loss.detach().item(), dict(zip(params, grads)),
                      fwd)
    torch.cuda.synchronize()
    (l0, g0, f0), (l1, g1, f1) = out["none"], out["dots"]
    assert f0 == f1 == n_mlstm, (f0, f1)
    assert l1 == pytest.approx(l0, rel=1e-6)
    scale = max(float(t.float().abs().max()) for t in g0.values())
    for name, want in g0.items():
        got = g1[name]
        np.testing.assert_allclose(N(got.float()), N(want.float()), rtol=0,
                                   atol=tol * scale, err_msg=name)
        if ".mlstm." in name:
            assert bool(torch.isfinite(got).all()) and bool(
                (got != 0).any()), name
