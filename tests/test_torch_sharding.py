"""The port's device-mesh layer (``repro_torch.launch.mesh``,
``repro_torch.sharding``) against the JAX package's.

* Specs, with no ranks: ``param_specs`` of all ten archs at full width
  on the (16, 16), (2, 16, 16), (2, 4) and (4, 2) meshes equal the
  reference's after the layout map (``models.convert.reference_leaf``:
  the stacked layers axis dropped, an ``nn.Linear`` weight's two dims
  swapped); ``batch_spec``, ``cache_specs`` and ``act_specs`` equal the
  reference's on every applicable ``SHAPE_SUITE`` shape. The reference
  functions read only ``mesh.axis_names`` and ``mesh.devices.shape``, so
  a stand-in mesh runs them for any size; ``act_specs`` builds
  ``NamedSharding``s, so it runs with ``NamedSharding`` stood in by its
  spec, and once more for real in one 8-device subprocess on the two
  small meshes.
* On 4 gloo ranks (one spawn for the file): ``psum_compressed`` against
  JAX's in that subprocess (the int8 payload equal, the mean and the new
  error within 1e-6, also with the error fed back), the reference's
  bias and drain properties of the error feedback, ``pipeline_forward``
  against JAX's (M 8, mb 2, S 4, D 16) within 1e-5, and ``make_mesh``'s
  refusals.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import config as jcfg  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro_torch import config as tcfg  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402
from repro_torch.models.convert import reference_leaf  # noqa: E402
from repro_torch.sharding import rules as trules  # noqa: E402

from helpers import check, run_with_devices  # noqa: E402
from test_torch_mesh_worker import result, run_ranks  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "4x2": ((4, 2), ("data", "model"))}
ARCHS = jcfg.list_archs()


def stand_in(mesh_id):
    """What the reference's and the port's rule functions read of a
    mesh, for a mesh of any size and no devices."""
    shape, axes = MESHES[mesh_id]
    return SimpleNamespace(axis_names=axes, devices=np.empty(shape),
                           mesh_dim_names=axes, shape=shape)


def norm(spec, rank):
    """A PartitionSpec or a port spec as a full-rank tuple."""
    entries = tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                    for e in spec)
    return entries + (None,) * (rank - len(entries))


def port_shape(shape: jcfg.ShapeConfig) -> tcfg.ShapeConfig:
    return tcfg.ShapeConfig(shape.name, tcfg.ShapeKind(shape.kind.value),
                            shape.seq_len, shape.global_batch)


@functools.lru_cache(maxsize=None)
def ref_param_shapes(arch):
    return jdec.init_params_shape(jcfg.get_arch(arch))


@functools.lru_cache(maxsize=None)
def port_model(arch):
    return tdec.Decoder(tcfg.get_arch(arch), device="meta")


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

def test_sharding_config_and_shape_suite_match_reference():
    ref, port = jcfg.ShardingConfig(), tcfg.ShardingConfig()
    assert [f.name for f in dataclasses.fields(port)] == \
        [f.name for f in dataclasses.fields(ref)]
    for f in dataclasses.fields(ref):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert tcfg.SHAPE_SUITE == {k: port_shape(v)
                                for k, v in jcfg.SHAPE_SUITE.items()}
    for arch in ARCHS:
        assert tcfg.applicable_shapes(arch) == jcfg.applicable_shapes(arch)
    with pytest.raises(ValueError):
        tcfg.ShardingConfig(remat="some")
    with pytest.raises(ValueError):
        tcfg.ShardingConfig(microbatches=0)


# ---------------------------------------------------------------------------
# specs, no ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_id", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mesh_id):
    mesh = stand_in(mesh_id)
    shapes = ref_param_shapes(arch)
    ref = jrules.param_specs(shapes, jcfg.ShardingConfig(), mesh)
    port = trules.param_specs(port_model(arch), tcfg.ShardingConfig(), mesh)
    n_sharded = 0
    for name, spec in port.items():
        path, layer, transposed = reference_leaf(name)
        ref_spec, ref_shape = ref, shapes
        for k in path:
            ref_spec, ref_shape = ref_spec[k], ref_shape[k]
        # the port's spec back in the reference's layout
        back = spec[::-1] if transposed else spec
        if layer is not None:
            back = (None,) + back
        assert back == norm(ref_spec, len(ref_shape.shape)), name
        n_sharded += any(e is not None for e in spec)
    assert n_sharded > len(port) // 2


@pytest.mark.parametrize("mesh_id", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match_reference(arch, mesh_id):
    mesh = stand_in(mesh_id)
    jc, tc = jcfg.get_arch(arch), tcfg.get_arch(arch)
    for name in jcfg.applicable_shapes(arch):
        shape = jcfg.SHAPE_SUITE[name]
        ref = jrules.batch_spec(shape, mesh, jcfg.ShardingConfig())
        port = trules.batch_spec(port_shape(shape), mesh,
                                 tcfg.ShardingConfig())
        assert port == norm(ref, 2), name
        b, s = shape.global_batch, shape.seq_len
        ref_cache = jax.eval_shape(lambda: jdec.init_cache(jc, b, s,
                                                           a3=True))
        ref_specs = jrules.cache_specs(ref_cache, shape, mesh,
                                       jcfg.ShardingConfig())
        port_cache = tdec.init_cache(tc, b, s, a3=True, device="meta")
        port_specs = trules.cache_specs(port_cache, port_shape(shape), mesh,
                                        tcfg.ShardingConfig())
        assert port_specs.keys() == ref_specs.keys()
        for seg, leaves in ref_specs.items():
            assert port_specs[seg].keys() == leaves.keys(), (name, seg)
            for leaf, spec in leaves.items():
                assert tuple(port_cache[seg][leaf].shape) == \
                    ref_cache[seg][leaf].shape
                assert port_specs[seg][leaf] == norm(
                    spec, len(ref_cache[seg][leaf].shape)), (name, seg, leaf)


@pytest.mark.parametrize("mesh_id", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_act_specs_match_reference(arch, mesh_id, monkeypatch):
    # the reference builds NamedShardings, which need real devices: stand
    # each in by its spec (the 8-device test below runs it for real)
    monkeypatch.setattr(jrules, "NamedSharding", lambda mesh, spec: spec)
    mesh = stand_in(mesh_id)
    for name in jcfg.applicable_shapes(arch):
        shape = jcfg.SHAPE_SUITE[name]
        ref = jrules.act_specs(jcfg.get_arch(arch), shape, mesh,
                               jcfg.ShardingConfig())
        port = trules.act_specs(tcfg.get_arch(arch), port_shape(shape), mesh,
                                tcfg.ShardingConfig())
        assert port.keys() == ref.keys(), name
        for kind, spec in ref.items():
            assert port[kind] == norm(spec, len(port[kind])), (name, kind)


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = stand_in("2x16x16")
    assert trules.placements_for((("pod", "data"), None), mesh) == \
        (Shard(0), Shard(0), Replicate())
    assert trules.placements_for(("model", "data"), mesh) == \
        (Replicate(), Shard(1), Shard(0))
    assert trules.placements_for((None, None), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        trules.placements_for((("data", "pod"),), mesh)


def test_mesh_refuses_without_a_card_or_a_group():
    import torch.distributed as dist
    import repro_torch.launch.mesh as tmesh     # importing touches nothing
    assert not dist.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmesh.make_mesh((1,), ("data",), device="cuda")
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh((1,), ("data",), device="cpu")


# ---------------------------------------------------------------------------
# the JAX side of the rank tests, in one 8-device subprocess
# ---------------------------------------------------------------------------

_JAX_REF = textwrap.dedent("""
    import json, sys
    from functools import partial
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from jax.experimental.shard_map import shard_map
    from repro.config import SHAPE_SUITE, ShardingConfig, applicable_shapes, \\
        get_arch, list_archs
    from repro.launch.mesh import make_mesh
    from repro.sharding.compression import compress_int8, psum_compressed
    from repro.sharding.pipeline import pipeline_forward
    from repro.sharding.rules import act_specs

    d = sys.argv[1]
    g = np.load(d + "/psum_in.npz")["g"]
    pods = make_mesh((4,), ("pod",))

    @partial(shard_map, mesh=pods, in_specs=P("pod"),
             out_specs=(P("pod"),) * 5, check_rep=False)
    def reduce_twice(gs):
        m1, e1 = psum_compressed({"g": gs[0]}, "pod")
        m2, e2 = psum_compressed({"g": gs[0]}, "pod", e1)
        amax = jax.lax.pmax(jnp.max(jnp.abs(gs[0])), "pod")
        q = compress_int8(gs[0], jnp.maximum(amax / 127.0, 1e-12))
        return tuple(t[None] for t in (m1["g"], e1["g"], m2["g"], e2["g"],
                                       q))

    out = dict(zip(("mean1", "err1", "mean2", "err2", "q"),
                   map(np.asarray, reduce_twice(g))))
    f = np.load(d + "/pipe_in.npz")
    out["pipe"] = np.asarray(pipeline_forward(
        lambda p, x: jnp.tanh(x @ p["w"]), {"w": jnp.asarray(f["w"])},
        jnp.asarray(f["x"]), make_mesh((4,), ("pipe",)), axis="pipe"))
    np.savez(d + "/jax_ref.npz", **out)

    specs = {}
    for shape, axes in (((2, 4), ("data", "model")),
                        ((4, 2), ("data", "model"))):
        mesh = make_mesh(shape, axes)
        for arch in list_archs():
            for name in applicable_shapes(arch):
                a = act_specs(get_arch(arch), SHAPE_SUITE[name], mesh,
                              ShardingConfig())
                specs[f"{shape}|{arch}|{name}"] = {
                    k: [list(e) if isinstance(e, tuple) else e
                        for e in v.spec] for k, v in a.items()}
    json.dump(specs, open(d + "/act_specs.json", "w"))
    print("OK")
""")

CASES = ("psum", "psum_feedback", "pipeline", "mesh_checks")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Inputs from numpy seeds; the JAX package's results (8-device
    subprocess) and the port's on 4 gloo ranks, in one directory."""
    d = tmp_path_factory.mktemp("mesh4")
    rng = np.random.default_rng(0)
    np.savez(d / "psum_in.npz",
             g=rng.standard_normal((4, 64)).astype(np.float32),
             g5=(rng.standard_normal((4, 64)) * 5.0).astype(np.float32))
    np.savez(d / "pipe_in.npz",
             w=(rng.standard_normal((4, 16, 16)) * 0.3).astype(np.float32),
             x=rng.standard_normal((8, 2, 4, 16)).astype(np.float32))
    check(run_with_devices(_JAX_REF.replace("sys.argv[1]", repr(str(d))),
                           devices=8))
    run_ranks(4, CASES, d)
    return d


def test_psum_compressed_matches_reference(ranks):
    got, want = result(ranks, "psum"), result(ranks, "jax_ref")
    np.testing.assert_array_equal(got["q"], want["q"])
    for k in ("mean1", "err1", "mean2", "err2"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    # every pod holds the same mean: the int8 sum, rescaled
    assert (got["mean1"] == got["mean1"][0]).all()


def test_psum_compressed_error_feedback_properties(ranks):
    """tests/test_sharding_multidev.py's bias and drain properties."""
    with np.load(ranks / "psum_in.npz") as f:
        g, g5 = f["g"], f["g5"]
    r = result(ranks, "psum_feedback")
    true = g.mean(0)
    bound = np.abs(g).max() / 127 + 1e-6
    err = np.abs(r["once"] - true).max()
    assert err <= bound
    # feedback reduces the bias of a repeated reduction
    assert np.abs(r["avg8"] - true).max() < 0.7 * err
    # the residual drains: under half a step (x 2.1) at every step, and
    # the summed means differ from 32 x the true mean by that residual
    step_bound = np.abs(g5).max() / 127 / 2
    assert (r["e_norm"] <= 2.1 * step_bound + 1e-6).all(), r["e_norm"]
    drift = np.abs(r["acc32"] / 32 - g5.mean(0)).max()
    assert drift <= (2.1 * step_bound + 1e-6) / 32 + 1e-6


def test_pipeline_forward_matches_reference(ranks):
    got, want = result(ranks, "pipeline")["out"], result(ranks, "jax_ref")
    with np.load(ranks / "pipe_in.npz") as f:
        ref = f["x"]
        for i in range(4):
            ref = np.tanh(ref @ f["w"][i])
    for out in got:                  # every rank holds the outputs
        np.testing.assert_allclose(out, want["pipe"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_make_mesh_on_ranks(ranks):
    r = result(ranks, "mesh_checks")
    assert r["refused"].tolist() == [True, True, True]
    assert r["coords"].tolist() == [[0, 0], [0, 1], [1, 0], [1, 1]]


@pytest.mark.parametrize("mesh_id", ["2x4", "4x2"])
def test_act_specs_on_devices_match(ranks, mesh_id):
    """The reference's real ``NamedSharding``s (8 host devices) give the
    port's specs."""
    specs = json.loads((ranks / "act_specs.json").read_text())
    shape, _ = MESHES[mesh_id]
    mesh = stand_in(mesh_id)
    n = 0
    for arch in ARCHS:
        for name in jcfg.applicable_shapes(arch):
            ref = specs[f"{shape}|{arch}|{name}"]
            port = trules.act_specs(tcfg.get_arch(arch),
                                    port_shape(jcfg.SHAPE_SUITE[name]),
                                    mesh, tcfg.ShardingConfig())
            assert port.keys() == ref.keys()
            for kind, spec in ref.items():
                assert port[kind] == norm(spec, len(port[kind]))
                n += 1
    assert n > 100
