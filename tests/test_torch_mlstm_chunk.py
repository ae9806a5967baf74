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
    before = tmk.LAUNCHES["mlstm_chunk"]
    h_k, st_k = tmk.mlstm_chunk_kernel(*tt, **kw)
    assert tmk.LAUNCHES["mlstm_chunk"] == before + 1
    h_p, st_p = tmk.mlstm_chunk_plain(*tt, **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(N(h_k), N(h_p), **SEQ)
    for name, a, w in zip("Cnm", st_k, st_p):
        np.testing.assert_allclose(N(a), N(w), **SEQ, err_msg=name)
