"""Flash attention (kernel #4) of the port vs the JAX package.

The plain version of the kernel is held against the Pallas kernel run
with ``interpret=True`` over ``tests/test_kernels.py``'s sweep, window
and prefill-offset cases, and the torch oracle against ``attention_ref``,
at 2e-5 (f32) / 2e-2 (bf16). The CUDA kernel runs only on a card: the
``cuda`` fixture skips those cases here. JAX is imported inside the
``jx`` fixture only, so ``pytest -m gpu --noconftest`` runs on a machine
without JAX.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import kernel as tfk  # noqa: E402
from repro_torch.kernels.flash_attention.ops import \
    fused_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    attention_ref  # noqa: E402

from test_torch_helpers import N, cuda, tol  # noqa: E402,F401

torch.set_num_threads(1)

DTYPES = ["float32", "bfloat16"]
# tests/test_kernels.py::test_flash_attention_sweep
SWEEP = [
    (1, 1, 1, 128, 128, 64, 64),
    (2, 4, 2, 256, 256, 64, 64),
    (1, 8, 1, 128, 384, 32, 32),     # MQA + prefill-continuation offset
    (1, 2, 2, 256, 256, 128, 64),    # dv != d
]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's flash kernel, oracle and public op."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_attention.kernel import flash_attention
    from repro.kernels.flash_attention.ops import fused_attention as jfused
    from repro.kernels.flash_attention.ref import attention_ref as jref
    return SimpleNamespace(jnp=jnp, flash=flash_attention, ref=jref,
                           fused=jfused)


def _qkv(seed, b, hq, hkv, sq, sk, d, dv, dtype):
    """numpy float32 q, k, v and the same as torch tensors in ``dtype``."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, dv))]
    return arrs, [torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in arrs]


def _jax(jx, arrs, dtype):
    return [jx.jnp.asarray(a, getattr(jx.jnp, dtype)) for a in arrs]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SWEEP, ids=str)
def test_flash_plain_matches_pallas(jx, shape, dtype):
    arrs, (tq, tk_, tv) = _qkv(sum(shape), *shape, dtype)
    ref = jx.flash(*_jax(jx, arrs, dtype), causal=True, interpret=True)
    out = tfk.flash_attention(tq, tk_, tv, causal=True)
    assert out.dtype == tq.dtype and tuple(out.shape) == tuple(ref.shape)
    np.testing.assert_allclose(N(out), N(ref), **tol(dtype))


@pytest.mark.parametrize("window", [64, 128, 1024])
def test_flash_window_matches_pallas(jx, window):
    """tests/test_kernels.py::test_flash_attention_window."""
    arrs, tt = _qkv(window, 1, 2, 2, 256, 256, 32, 32, "float32")
    ref = jx.flash(*_jax(jx, arrs, "float32"), causal=True, window=window,
                   interpret=True)
    out = tfk.flash_attention(*tt, causal=True, window=window)
    np.testing.assert_allclose(N(out), N(ref), **tol("float32"))


@pytest.mark.parametrize("causal,window", [(False, 100), (True, 200)])
def test_flash_offset_and_mask_kinds_match_pallas(jx, causal, window):
    """A prefill continuation (Sq=128 against Sk=384, GQA 4) without the
    causal mask, and with a window that cuts the first kv tiles."""
    arrs, tt = _qkv(3, 1, 8, 2, 128, 384, 32, 32, "float32")
    ref = jx.flash(*_jax(jx, arrs, "float32"), causal=causal, window=window,
                   interpret=True)
    out = tfk.flash_attention(*tt, causal=causal, window=window)
    np.testing.assert_allclose(N(out), N(ref), **tol("float32"))


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_ref_matches_jax_ref(jx, dtype):
    arrs, tt = _qkv(5, 1, 4, 2, 128, 256, 32, 32, dtype)
    ref = jx.ref(*_jax(jx, arrs, dtype), causal=True, window=96)
    out = attention_ref(*tt, causal=True, window=96)
    np.testing.assert_allclose(N(out), N(ref), **tol(dtype))


def test_fused_attention_matches_jax(jx):
    """The public op: the tensors' device picks the route (here the plain
    version), against the JAX op's kernel path in interpret mode."""
    arrs, tt = _qkv(9, 2, 4, 2, 256, 256, 32, 32, "float32")
    ref = jx.fused(*_jax(jx, arrs, "float32"), causal=True, window=160,
                   use_kernel=True, interpret=True)
    out = fused_attention(*tt, causal=True, window=160)
    np.testing.assert_allclose(N(out), N(ref), **tol("float32"))
    np.testing.assert_allclose(N(out), N(attention_ref(*tt, window=160)),
                               **tol("float32"))


def test_cpu_route_is_plain_and_counts_no_launch():
    _, tt = _qkv(1, 1, 2, 1, 128, 128, 32, 32, "float32")
    before = dict(tfk.LAUNCHES)
    out = tfk.flash_attention(*tt)
    assert torch.equal(out, tfk.flash_attention_plain(*tt))
    assert tfk.LAUNCHES == before


def test_wrapper_rejects_bad_shapes():
    _, (tq, tk_, tv) = _qkv(1, 1, 2, 1, 384, 384, 32, 32, "float32")
    with pytest.raises(ValueError, match="multiples"):
        tfk.flash_attention(tq, tk_, tv, block_q=256)
    with pytest.raises(ValueError, match="shape mismatch"):
        tfk.flash_attention(tq, tk_[..., :16], tv)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sq,window", [(2048, None), (2048, 512),
                                       (512, None)])
def test_cuda_flash_matches_plain(cuda, sq, window, dtype):
    """On the card: kernel #4 vs its plain version at phi4-mini's
    attention width (Hq=24, Hkv=8, D=128, Sk=2048): causal, a 512 window
    and a 512-row prefill continuation."""
    _, tt = _qkv(sq, 1, 24, 8, sq, 2048, 128, 128, dtype)
    tq, tk_, tv = [t.to(cuda) for t in tt]
    out = tfk.flash_attention(tq, tk_, tv, window=window)
    want = tfk.flash_attention_plain(tq, tk_, tv, window=window)
    np.testing.assert_allclose(N(out), N(want), **tol(dtype))


@pytest.mark.parametrize("dtype,d,dv,aligned,scale,want", [
    (torch.bfloat16, 128, 128, True, 0.09, "flash_attention_wgmma"),
    (torch.bfloat16, 64, 64, True, 0.125, "flash_attention_wgmma"),
    (torch.bfloat16, 128, 64, True, 1.0, "flash_attention_wgmma"),
    (torch.bfloat16, 16, 96, True, 0.25, "flash_attention_wgmma"),
    (torch.bfloat16, 72, 72, True, 0.1, "flash_attention_simt"),   # not x16
    (torch.bfloat16, 128, 40, True, 0.1, "flash_attention_simt"),
    (torch.bfloat16, 144, 144, True, 0.1, "flash_attention_simt"),  # > 128
    (torch.bfloat16, 256, 256, True, 0.1, "flash_attention_simt"),
    (torch.float32, 256, 256, True, 0.1, "flash_attention_simt"),
    (torch.bfloat16, 128, 128, False, 0.1, "flash_attention_simt"),
    (torch.bfloat16, 128, 128, True, -0.1, "flash_attention_simt"),
    (torch.float32, 128, 128, True, 0.1, "flash_attention_simt"),
])
def test_kernel_route_by_dtype_and_head_dims(dtype, d, dv, aligned, scale,
                                            want):
    """The route a CUDA call takes is a function of dtype, head dims,
    alignment and the scale's sign, decided before the launch."""
    assert tfk.kernel_route(dtype, d, dv, aligned, scale) == want
    assert set(tfk.LAUNCHES) == {"flash_attention_wgmma",
                                 "flash_attention_simt"}


# (b, hq, hkv, sq, sk, d, dv, window): the tensor-core route's edges
WGMMA_CASES = [
    (1, 4, 2, 96, 96, 128, 128, None),      # under one tile
    (1, 24, 8, 128, 2048, 128, 128, None),  # continuation, Sq=128
    (1, 4, 2, 512, 512, 128, 128, 100),     # window not a tile multiple
    (2, 4, 2, 256, 256, 64, 64, None),      # D = Dv = 64
    (1, 4, 1, 200, 328, 32, 96, 150),       # short D, Dv in two boxes
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", WGMMA_CASES, ids=str)
def test_cuda_flash_wgmma_route_matches_plain(cuda, case):
    """On the card: bf16 calls take the tensor-core kernel and agree
    with the plain version."""
    b, hq, hkv, sq, sk, d, dv, window = case
    _, tt = _qkv(sq + d, b, hq, hkv, sq, sk, d, dv, "bfloat16")
    tq, tk_, tv = [t.to(cuda) for t in tt]
    tfk.reset_launch_counts()
    out = tfk.flash_attention(tq, tk_, tv, window=window, block_q=8,
                              block_k=8)
    assert tfk.LAUNCHES == {"flash_attention_wgmma": 1,
                            "flash_attention_simt": 0}
    want = tfk.flash_attention_plain(tq, tk_, tv, window=window,
                                     block_q=8, block_k=8)
    np.testing.assert_allclose(N(out), N(want), **tol("bfloat16"))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d", [("float32", 128), ("bfloat16", 72)])
def test_cuda_flash_simt_route_matches_plain(cuda, dtype, d):
    """On the card: float32, and bf16 at a head dim the wgmma tiles do
    not take, run the CUDA-core kernel."""
    _, tt = _qkv(d, 1, 4, 2, 256, 256, d, d, dtype)
    tq, tk_, tv = [t.to(cuda) for t in tt]
    tfk.reset_launch_counts()
    out = tfk.flash_attention(tq, tk_, tv, window=160)
    assert tfk.LAUNCHES == {"flash_attention_wgmma": 0,
                            "flash_attention_simt": 1}
    want = tfk.flash_attention_plain(tq, tk_, tv, window=160)
    np.testing.assert_allclose(N(out), N(want), **tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [None, 96])
def test_flash_plain_head_dim_256_matches_pallas(jx, window, dtype):
    """gemma3-4b's head dim (D = Dv = 256) at S = 256 with 128-row
    blocks, GQA 2: the plain version against the Pallas kernel in
    interpret mode."""
    arrs, tt = _qkv(256, 1, 4, 2, 256, 256, 256, 256, dtype)
    ref = jx.flash(*_jax(jx, arrs, dtype), causal=True, window=window,
                   interpret=True)
    out = tfk.flash_attention(*tt, causal=True, window=window)
    assert tuple(out.shape) == (1, 4, 256, 256) and out.dtype == tt[0].dtype
    np.testing.assert_allclose(N(out), N(ref), **tol(dtype))


# (b, hq, hkv, sq, sk, d, dv, window): head dims above the tensor cores'
HEAD_DIM_256_CASES = [
    (1, 1, 1, 128, 128, 256, 256, None),     # the smallest input
    (1, 8, 4, 2048, 2048, 256, 256, None),   # gemma3-4b's attention width
    (1, 8, 4, 2048, 2048, 256, 256, 1024),   # and its sliding window
    (1, 8, 4, 512, 2048, 256, 256, None),    # a continuation
    (1, 4, 2, 256, 256, 256, 128, None),     # Dv = 128 beside D = 256
    (1, 4, 2, 256, 256, 64, 200, 100),       # Dv in (128, 256]
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", HEAD_DIM_256_CASES, ids=str)
def test_cuda_flash_head_dim_256_matches_plain(cuda, case, dtype):
    """On the card: head dims up to 256 take the CUDA-core kernel (16
    value columns a thread) and agree with the plain version; bf16
    [1, 1, 128, 256] returns [1, 1, 128, 256]."""
    b, hq, hkv, sq, sk, d, dv, window = case
    _, tt = _qkv(d + dv, b, hq, hkv, sq, sk, d, dv, dtype)
    tq, tk_, tv = [t.to(cuda) for t in tt]
    tfk.reset_launch_counts()
    out = tfk.flash_attention(tq, tk_, tv, window=window)
    assert tfk.LAUNCHES == {"flash_attention_wgmma": 0,
                            "flash_attention_simt": 1}
    assert tuple(out.shape) == (b, hq, sq, dv) and out.dtype == tq.dtype
    want = tfk.flash_attention_plain(tq, tk_, tv, window=window)
    np.testing.assert_allclose(N(out), N(want), **tol(dtype))
