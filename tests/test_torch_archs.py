"""Every arch the port registers vs the JAX package, as the smoke variant
of each (``smoke_variant``, float32) with the reference's weights carried
over: the full-sequence ``forward`` logits and MoE aux loss, whole-prompt
``prefill`` logits and caches (A^3 sort leaves included), and one decode
step after it, within the reference's own 2e-4 for logits through a
whole smoke model (``tests/test_archs_smoke.py``); the two frontend
archs take tokens here too (their embeddings input is in
``tests/test_torch_frontend.py``). Plus the registry: the JAX package's
archs, all ten, each config and smoke variant equal field for field, and
``param_count`` equal on the full configs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import config as jcfg  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro_torch import config as tcfg  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

from test_torch_helpers import N, T, assert_cache_close, \
    port_cfg  # noqa: E402

torch.set_num_threads(1)

FRONTEND = ("internvl2-2b", "musicgen-medium")
ARCHS = tcfg.list_archs()
TOL = dict(rtol=2e-4, atol=2e-4)
B, S = 2, 32


def test_registry_is_the_reference_minus_frontends():
    """The name is kept from when the port lacked the frontend archs: the
    registry now equals the reference's, the frontend archs included."""
    assert ARCHS == jcfg.list_archs()
    assert len(ARCHS) == 10
    for arch in FRONTEND:
        assert jcfg.get_arch(arch).frontend
        assert tcfg.get_arch(arch).frontend == jcfg.get_arch(arch).frontend


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_param_count_match(arch):
    ref, port = jcfg.get_arch(arch), tcfg.get_arch(arch)
    assert port == port_cfg(ref)
    assert tcfg.smoke_variant(port) == port_cfg(jcfg.smoke_variant(ref))
    assert port.param_count() == ref.param_count()


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    cfg = dataclasses.replace(jcfg.smoke_variant(jcfg.get_arch(request.param)),
                              dtype="float32")
    params = jdec.init_params(jax.random.PRNGKey(0), cfg)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                              port_cfg(cfg), device="cpu")
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    return cfg, port_cfg(cfg), params, model, toks


def test_forward_matches(smoke):
    cfg, tc, params, model, toks = smoke
    lg, aux = jdec.forward(params, cfg, jnp.asarray(toks))
    tlg, taux = tdec.forward(model, tc, T(toks))
    assert tlg.shape == (B, S, tdec.padded_vocab(cfg.vocab_size))
    np.testing.assert_allclose(N(tlg), N(lg), **TOL)
    np.testing.assert_allclose(float(taux["moe_aux_loss"]),
                               float(aux["moe_aux_loss"]), **TOL)
    assert (float(aux["moe_aux_loss"]) > 0) == (cfg.moe is not None)


def test_prefill_matches(smoke):
    cfg, tc, params, model, toks = smoke
    lg, cache = jdec.prefill(params, cfg, jnp.asarray(toks), max_len=S + 4,
                             a3=True)
    tlg, tcache = tdec.prefill(model, tc, T(toks), max_len=S + 4, a3=True)
    np.testing.assert_allclose(N(tlg), N(lg), **TOL)
    assert_cache_close(tcache, cache, TOL["rtol"], TOL["atol"])


def test_decode_step_matches(smoke):
    """Prefill S - 1 tokens, then decode the last one at position S - 1:
    logits and every cache leaf."""
    cfg, tc, params, model, toks = smoke
    _, cache = jdec.prefill(params, cfg, jnp.asarray(toks[:, :S - 1]),
                            max_len=S + 4)
    _, tcache = tdec.prefill(model, tc, T(toks[:, :S - 1]), max_len=S + 4)
    lg, cache = jdec.decode_step(params, cfg, cache,
                                 jnp.asarray(toks[:, S - 1]), jnp.int32(S - 1))
    tlg, tcache = tdec.decode_step(model, tc, tcache, T(toks[:, S - 1]),
                                   S - 1)
    np.testing.assert_allclose(N(tlg), N(lg), **TOL)
    assert_cache_close(tcache, cache, TOL["rtol"], TOL["atol"])
