"""The port's AdamW (``repro_torch.optim.adamw``) vs the JAX package's.

Five steps of ``adamw_update`` from the same parameters and gradients
(made with numpy) on a tree with float32 and bfloat16 leaves, with float32
and with bfloat16 first moments: float32 parameters, m and v within 1e-6
relative to each entry and to the tensor's largest magnitude (the clip
factor comes from a norm summed in another order, and a moment near zero
is a difference of such products); bf16 leaves within one bf16 step (2^-7 relative: a float32
intermediate that rounds the other way moves a bf16 value by one step).
``cosine_schedule`` at the steps of ``tests/test_substrate.py``,
``global_norm`` and the clip; then that file's four optimizer cases
restated on the port, with its numpy hand reference.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.config import OptimizerConfig as JOpt  # noqa: E402
from repro.optim import adamw as ja  # noqa: E402
from repro_torch.config import OptimizerConfig as TOpt  # noqa: E402
from repro_torch.optim import adamw as ta  # noqa: E402

from test_torch_helpers import N  # noqa: E402

torch.set_num_threads(1)

SHAPES = {"w": (8, 16), "b": (16,), "emb": (32, 8)}
BF16_LEAVES = ("emb",)


def _tree(rng):
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("m_dtype", ["float32", "bfloat16"])
def test_adamw_five_steps_match_reference(m_dtype):
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, m_dtype=m_dtype,
              grad_clip_norm=3.0)
    jc, tc = JOpt(**kw), TOpt(**kw)
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    jp = {k: jnp.asarray(v, jnp.bfloat16 if k in BF16_LEAVES else
                         jnp.float32) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(torch.bfloat16 if k in BF16_LEAVES
                                    else torch.float32)
          for k, v in p0.items()}
    js, ts = ja.adamw_init(jp, jc), ta.adamw_init(tp, tc)
    assert {k: str(v.dtype) for k, v in ts.m.items()} == {
        k: f"torch.{m_dtype}" for k in SHAPES}
    for _ in range(5):
        g = _tree(rng)
        jg = {k: jnp.asarray(v).astype(jp[k].dtype) for k, v in g.items()}
        tg = {k: torch.from_numpy(v).to(tp[k].dtype) for k, v in g.items()}
        jp, js, jm = ja.adamw_update(jg, js, jp, jc)
        tp, ts, tm = ta.adamw_update(tg, ts, tp, tc)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(ts.step) == int(js.step) == 5
    for k in SHAPES:
        for got, want, bf16 in ((tp[k], jp[k], k in BF16_LEAVES),
                                (ts.m[k], js.m[k], m_dtype == "bfloat16"),
                                (ts.v[k], js.v[k], False)):
            w = np.asarray(want.astype(jnp.float32))
            if bf16:
                np.testing.assert_allclose(N(got), w, rtol=2 ** -7,
                                           atol=0, err_msg=k)
            else:
                np.testing.assert_allclose(
                    N(got), w, rtol=1e-6,
                    atol=1e-6 * float(np.abs(w).max()), err_msg=k)


def test_schedule_norm_and_clip_match_reference():
    kw = dict(lr=1.0, warmup_steps=10, total_steps=110, min_lr_ratio=0.1)
    for s in [0, 5, 10, 60, 110, 200]:
        assert float(ta.cosine_schedule(TOpt(**kw), torch.tensor(s))) == \
            pytest.approx(float(ja.cosine_schedule(JOpt(**kw),
                                                   jnp.asarray(s))),
                          rel=1e-6, abs=1e-7)
    g = _tree(np.random.default_rng(1))
    assert float(ta.global_norm({k: torch.from_numpy(v)
                                 for k, v in g.items()})) == pytest.approx(
        float(ja.global_norm({k: jnp.asarray(v) for k, v in g.items()})),
        rel=1e-6)
    # a clipped step: the norm reported before the clip, the same update
    cfg = dict(lr=1e-2, warmup_steps=0, grad_clip_norm=0.5)
    p = {"w": np.ones((4, 4), np.float32)}
    grad = {"w": np.full((4, 4), 3.0, np.float32)}
    jp, _, jm = ja.adamw_update({"w": jnp.asarray(grad["w"])},
                                ja.adamw_init({"w": jnp.asarray(p["w"])},
                                              JOpt(**cfg)),
                                {"w": jnp.asarray(p["w"])}, JOpt(**cfg))
    tp = {"w": torch.from_numpy(p["w"].copy())}
    tp, _, tm = ta.adamw_update({"w": torch.from_numpy(grad["w"])},
                                ta.adamw_init(tp, TOpt(**cfg)), tp,
                                TOpt(**cfg))
    assert float(tm["grad_norm"]) == pytest.approx(12.0)
    np.testing.assert_allclose(N(tp["w"]), np.asarray(jp["w"]), rtol=1e-6)


# ---------------------------------------------------------------------------
# tests/test_substrate.py's optimizer cases, restated
# ---------------------------------------------------------------------------

def test_adamw_matches_hand_reference():
    """One AdamW step against a hand-rolled numpy reference."""
    cfg = TOpt(lr=1e-2, warmup_steps=0, total_steps=100, weight_decay=0.1,
               grad_clip_norm=1e9)
    w = np.asarray([[1.0, -2.0], [0.5, 3.0]], np.float32)
    gw = np.asarray([[0.1, 0.2], [-0.3, 0.4]], np.float32)
    p = {"w": torch.from_numpy(w.copy())}
    st = ta.adamw_init(p, cfg)
    newp, _, _ = ta.adamw_update({"w": torch.from_numpy(gw)}, st, p, cfg)

    lr = float(ta.cosine_schedule(cfg, torch.tensor(1)))
    m = 0.1 * gw
    v = 0.05 * gw ** 2
    mh, vh = m / 0.1, v / 0.05
    ref = w - lr * (mh / (np.sqrt(vh) + cfg.eps) + 0.1 * w)
    np.testing.assert_allclose(N(newp["w"]), ref, rtol=1e-5)


def test_grad_clipping():
    cfg = TOpt(lr=1e-2, warmup_steps=0, grad_clip_norm=0.1)
    p = {"w": torch.ones((4,))}
    g = {"w": torch.full((4,), 100.0)}
    _, _, metrics = ta.adamw_update(g, ta.adamw_init(p, cfg), p, cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)


def test_cosine_schedule_shape():
    cfg = TOpt(lr=1.0, warmup_steps=10, total_steps=110, min_lr_ratio=0.1)
    lrs = [float(ta.cosine_schedule(cfg, torch.tensor(s)))
           for s in [0, 5, 10, 60, 110, 200]]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0)
    assert 0.1 < lrs[3] < 1.0
    assert lrs[4] == pytest.approx(0.1, abs=1e-6)
    assert lrs[5] == pytest.approx(0.1, abs=1e-6)


def test_bf16_m_state_dtype():
    cfg = TOpt(m_dtype="bfloat16")
    st = ta.adamw_init({"w": torch.ones((4,), dtype=torch.bfloat16)}, cfg)
    assert st.m["w"].dtype == torch.bfloat16
    assert st.v["w"].dtype == torch.float32
