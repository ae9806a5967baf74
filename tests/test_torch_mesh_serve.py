"""The serving dispatches of the port on a mesh, on gloo CPU ranks, against
the JAX package's single-device dispatches of the same inputs and
parameters, and against the per-device matmul FLOPs of the reference's
GSPMD programs (``repro.launch.dryrun.lower_*``).

One spawn of 4 ranks and one of 8 (``test_torch_mesh_worker.py``,
``SERVE_CELLS``): TINY at batch 8 on (data 2, model 2) and (2, 4), TINY
at batch 1 on (2, 4) (the ring over (data, model)), TINY with 6 heads
and the f32 smoke deepseek-moe-16b, recurrentgemma-2b and xlstm-350m on
(2, 4). Each rank holds
its share of the parameters (DTensors by the rules) and of the cache
(its lanes, its ring rows, its recurrent channels), and runs:

* ``prefill`` of 64-token prompts with the A^3 sort over ``select_shards``
  = the ring's ranks (on (2, 4) also of 40-token prompts, which leave a
  rank's ring rows unwritten);
* ``decode_step`` from a 48-token prefill, A^3 off and conservative
  (the compact path over the split ring);
* ``decode_block``, 4 greedy steps; ``prefill_chunk`` of a ragged
  16-token chunk after a first one;
* on (2, 4) also ``chunk_a3``: two chunks of a chunked prefill with A^3,
  then the conservative decode step (the whole ring's sort, as one
  device keeps it).

Held: the whole logits within 2e-5 of JAX's, greedy tokens equal, each
rank's share of the result cache within 2e-5 of the same share of
JAX's, the A^3 sorted rows exactly equal, and each rank's
``FlopCounterMode`` count against the reference's per-device
``dot_flops()`` of the same cell: equal where GSPMD splits the cell into
1/devices, no higher where it keeps work replicated (TINY's batch-1
prefill and 6-head decode; the MoE's routed experts run over each
rank's block of the capacity slots).
The port's dry run traces each cell in a fake world of its size and is
held to the gloo rank's count, and TINY's one-device cells to the
reference's one-device count.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import config as jcfg  # noqa: E402
from repro.models import decoder as jd  # noqa: E402

from helpers import SRC  # noqa: E402
from test_torch_helpers import TINY  # noqa: E402
from test_torch_mesh_worker import CHUNK, DECODE_FROM, SERVE_CELLS, \
    SERVE_SEQ, result, run_ranks, save_tree, serve_inputs_name, \
    start_ranks  # noqa: E402

CONFIGS = {"tiny": TINY,
           "tiny-6h": dataclasses.replace(TINY, name="tiny-6h", num_heads=6),
           "moe": dataclasses.replace(jcfg.smoke_variant(
               jcfg.get_arch("deepseek-moe-16b")), dtype="float32"),
           "rg": dataclasses.replace(jcfg.smoke_variant(
               jcfg.get_arch("recurrentgemma-2b")), dtype="float32"),
           "xl": dataclasses.replace(jcfg.smoke_variant(
               jcfg.get_arch("xlstm-350m")), dtype="float32")}
TOL = 2e-5


def start_with_devices(code: str, devices: int = 8):
    """``helpers.run_with_devices``'s subprocess, started and not waited
    for."""
    env = dict(os.environ,
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _tol(name, want):
    """TINY's logits within 2e-5; the smoke archs' (4x as wide, logits to
    ~30) within 2e-5 of their largest."""
    return TOL if name == "tiny" else TOL * max(1.0, float(np.abs(want).max()))

# the reference's per-device dot FLOPs of each serving cell, as
# ``HloModule.dot_flops()`` counts its ``lower_*`` on an 8-device mesh
_JAX_FLOPS = """
import dataclasses, numpy as np, jax
from jax.sharding import Mesh
from repro import config as C
from repro.launch import dryrun as D
from repro.launch.hlo_analysis import HloModule
TINY = C.ModelConfig("tiny", "dense", num_layers=2, d_model=64, num_heads=4,
                     num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
                     dtype="float32")
CF = {"tiny": TINY, "tiny-6h": dataclasses.replace(TINY, name="tiny-6h",
                                                   num_heads=6)}
for a, n in (("recurrentgemma-2b", "rg"), ("xlstm-350m", "xl"),
             ("deepseek-moe-16b", "moe")):
    CF[n] = dataclasses.replace(C.smoke_variant(C.get_arch(a)),
                                dtype="float32")
SH = C.ShardingConfig(remat="none")
for name, ms, b, tags in %(cells)r:
    cfg = CF[name]
    mesh = Mesh(np.array(jax.devices()[:ms[0] * ms[1]]).reshape(ms),
                ("data", "model"))
    pre = C.ShapeConfig("p", C.ShapeKind.PREFILL, %(seq)d, b)
    dec = C.ShapeConfig("d", C.ShapeKind.DECODE, %(seq)d, b)
    ns = ms[1] if b %% ms[0] == 0 and b >= ms[0] else ms[0] * ms[1]
    a3 = dataclasses.replace(C.A3Config.conservative(), select_shards=ns)
    for tag in tags.split():
        with mesh:
            if tag == "prefill":
                low = D.lower_prefill(cfg, pre, mesh, SH)
            elif tag == "prefill_short":
                low = D.lower_prefill(cfg, C.ShapeConfig(
                    "p", C.ShapeKind.PREFILL, %(short)d, b), mesh, SH)
            elif tag == "decode":
                low = D.lower_decode(cfg, dec, mesh, SH)
            elif tag == "decode_a3":
                low = D.lower_decode(cfg, dec, mesh, SH, a3)
            elif tag == "decode_block":
                low = D.lower_decode_block(cfg, dec, mesh, SH, steps=4)
            else:
                low = D.lower_prefill_chunk(cfg, pre, mesh, SH,
                                            chunk=%(chunk)d)
            txt = low.compile().as_text()
        print("FLOPS", name, "x".join(map(str, ms)), b, tag,
              HloModule(txt).dot_flops())
"""


# the reference's dispatches, jitted (eager vmap-of-scan costs seconds a
# call; the models take no LUT path, whose cache a trace would poison)
_prefill = jax.jit(jd.prefill, static_argnames=(
    "cfg", "max_len", "attn_chunk", "a3", "select_shards"))
_decode_step = jax.jit(jd.decode_step, static_argnames=(
    "cfg", "a3", "use_kernel", "probe"))
_decode_block = jax.jit(jd.decode_block, static_argnames=(
    "cfg", "steps", "a3", "use_kernel", "resort_every", "temperature",
    "probe"))
_prefill_chunk = jax.jit(jd.prefill_chunk, static_argnames=(
    "cfg", "a3", "update_sort"))


def _jax_inputs(d, name, batch, tags, sels):
    """The reference's parameters, inputs and result caches of one config
    and batch for the dispatches ``tags`` (A^3 over ``sels`` selection
    blocks) -> (logits / tokens by dispatch), written for the ranks."""
    cfg = CONFIGS[name]
    params = jd.init_params(jax.random.PRNGKey(0), cfg)
    if not (d / f"init_{name}.npz").exists():
        save_tree(d / f"init_{name}.npz",
                  jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.default_rng(7 + batch)
    tokens = rng.integers(0, cfg.vocab_size, (batch, SERVE_SEQ)).astype(
        np.int32)
    dec_pos = np.full((batch,), DECODE_FROM, np.int32)
    if batch > 3:
        dec_pos[3] = -1                        # a ride-along lane
    steps_left = np.full((batch,), 4, np.int32)
    if batch > 5:
        steps_left[5] = 2
    chunk_len = np.full((batch,), CHUNK, np.int32)
    chunk_len[:min(batch, 4)] = [CHUNK, 10, 0, 1][:min(batch, 4)]
    x = dict(tokens=tokens, dec_token=tokens[:, DECODE_FROM], dec_pos=dec_pos,
             steps_left=steps_left, chunk_tokens=tokens[:, CHUNK:2 * CHUNK],
             chunk_pos=np.full((batch,), CHUNK, np.int32),
             chunk_len=chunk_len)
    tag = serve_inputs_name(name, batch)
    np.savez(d / f"{tag}_x.npz", **x)
    J = lambda a: jnp.asarray(a)  # noqa: E731
    out, trees = {}, {}
    # prefill (the A^3 sort over the ring's ranks)
    for sel in sels:
        logits, cache = _prefill(params, cfg=cfg, tokens=J(tokens),
                                 max_len=SERVE_SEQ, a3=True,
                                 select_shards=sel)
        out[f"prefill/{sel}/logits"] = np.asarray(logits)
        trees[f"prefill_{sel}/cache_out"] = cache
    if "prefill_short" in tags:
        logits, cache = _prefill(params, cfg=cfg,
                                 tokens=J(tokens[:, :DECODE_FROM - 8]),
                                 max_len=SERVE_SEQ, a3=True, select_shards=4)
        out["prefill_short/logits"] = np.asarray(logits)
        trees["prefill_short/cache_out"] = cache
    _, c_off = _prefill(params, cfg=cfg, tokens=J(tokens[:, :DECODE_FROM]),
                        max_len=SERVE_SEQ)
    trees["decode_in"] = c_off
    logits, cache = _decode_step(params, cfg=cfg, cache=c_off,
                                 token=J(x["dec_token"]), pos=J(dec_pos))
    out["decode/logits"] = np.asarray(logits)
    trees["decode/cache_out"] = cache
    if "decode_a3" in tags:
        for sel in sels:
            _, c_a3 = _prefill(params, cfg=cfg,
                               tokens=J(tokens[:, :DECODE_FROM]),
                               max_len=SERVE_SEQ, a3=True, select_shards=sel)
            trees[f"decode_a3_in_{sel}"] = c_a3
            a3 = dataclasses.replace(jcfg.A3Config.conservative(),
                                     select_shards=sel)
            logits, cache = _decode_step(params, cfg=cfg, cache=c_a3,
                                         token=J(x["dec_token"]),
                                         pos=J(dec_pos), a3=a3)
            out[f"decode_a3/{sel}/logits"] = np.asarray(logits)
            trees[f"decode_a3_{sel}/cache_out"] = cache
    if "decode_block" in tags:
        ring, carry, cache = _decode_block(
            params, cfg=cfg, cache=c_off, token=J(x["dec_token"]),
            pos=J(dec_pos), steps_left=J(steps_left), steps=4)
        out["decode_block/ring"] = np.asarray(ring)
        out["decode_block/carry"] = np.asarray(carry)
        trees["decode_block/cache_out"] = cache
    if "chunk" in tags:
        c0 = jd.init_cache(cfg, batch, SERVE_SEQ)
        _, c1 = _prefill_chunk(params, cfg=cfg, cache=c0,
                               tokens=J(tokens[:, :CHUNK]),
                               pos=J(np.zeros((batch,), np.int32)),
                               length=J(np.full((batch,), CHUNK, np.int32)))
        trees["chunk_in"] = c1
        logits, cache = _prefill_chunk(
            params, cfg=cfg, cache=c1, tokens=J(x["chunk_tokens"]),
            pos=J(x["chunk_pos"]), length=J(chunk_len))
        out["chunk/logits"] = np.asarray(logits)
        trees["chunk/cache_out"] = cache
    if "chunk_a3" in tags:
        _chunk_a3_inputs(params, cfg, batch, x, tokens, trees, out)
    save_tree(d / f"{tag}.npz", jax.tree_util.tree_map(np.asarray, trees))
    return out


def _gather_inputs(d):
    """The reference's warm-admission copy (``gather_fn``) of lane
    ``si``'s matched prefix from an fp and an int8 pool of random pages
    into TINY's A^3 cache -> ``gather_in.npz`` for the ranks, with the
    result caches as the reference made them."""
    from repro.models.mixer import build_segments
    from repro.serve.prefix_cache import gather_fn
    from test_torch_mesh_worker import GATHER
    g, cfg = GATHER, CONFIGS["tiny"]
    params = jd.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab_size, (8, DECODE_FROM)).astype(
        np.int32)
    _, cache = _prefill(params, cfg=cfg, tokens=jnp.asarray(tokens),
                        max_len=SERVE_SEQ, a3=True,
                        select_shards=g["select_shards"])
    perm = rng.permutation(g["pages"])
    p = np.arange(SERVE_SEQ)
    idx = {"page": perm[p // g["page_size"]].astype(np.int32),
           "off": (p % g["page_size"]).astype(np.int32),
           "valid": p < g["t"]}
    trees = {"cache": cache, "idx": idx}
    for kind in ("none", "int8"):
        pool = jd.init_page_pool(cfg, g["pages"], g["page_size"], a3=True,
                                 kv_quant=kind)
        fill = {}
        for s_, leaves in pool.items():
            fill[s_] = {}
            for k, v in leaves.items():
                if k.endswith("scale"):
                    a = rng.uniform(0.01, 0.05, v.shape)
                elif v.dtype == jnp.int8:
                    a = rng.integers(-127, 128, v.shape)
                else:
                    a = rng.standard_normal(v.shape)
                fill[s_][k] = jnp.asarray(a, dtype=v.dtype)
        out = gather_fn(build_segments(cfg), True, cache, fill, g["si"],
                        g["t"], {"seg0": {k: jnp.asarray(v)
                                          for k, v in idx.items()}}, {}, {})
        trees[f"pool_{kind}"] = fill
        trees[f"gather_{kind}"] = {"cache_out": out}
    save_tree(d / "gather_in.npz", jax.tree_util.tree_map(np.asarray, trees))


def _chunk_a3_inputs(params, cfg, batch, x, tokens, trees, out):
    """``chunk_a3``: the reference's two chunks of a chunked prefill with
    A^3 from an empty cache, and its conservative decode step from
    there."""
    J = lambda a: jnp.asarray(a)  # noqa: E731
    c = jd.init_cache(cfg, batch, SERVE_SEQ, a3=True)
    _, c = _prefill_chunk(params, cfg=cfg, cache=c,
                          tokens=J(tokens[:, :CHUNK]),
                          pos=J(np.zeros((batch,), np.int32)),
                          length=J(np.full((batch,), CHUNK, np.int32)),
                          a3=True)
    _, c = _prefill_chunk(params, cfg=cfg, cache=c,
                          tokens=J(x["chunk_tokens"]), pos=J(x["chunk_pos"]),
                          length=J(x["chunk_len"]), a3=True)
    trees["chunk_a3/cache_out"] = c
    a3 = dataclasses.replace(jcfg.A3Config.conservative(),
                             select_shards=_ns("serve_tiny_2x4"))
    logits, _ = _decode_step(params, cfg=cfg, cache=c,
                             token=J(tokens[:, 2 * CHUNK]),
                             pos=J(x["chunk_pos"] + x["chunk_len"]), a3=a3)
    out["chunk_a3/logits"] = np.asarray(logits)


# each gloo cell traced by the port's dry run in a fake world of its size
# (this process rank 0 of its ranks, fake tensors on the CPU: the plain
# route), and TINY's cells on one device
_DRY = """
import dataclasses, json
from test_torch_mesh_worker import configs
from repro_torch import config as C
from repro_torch.launch.dryrun import run_cell
out = {}
for name, ms, b, tag in %(cells)r:
    kind = C.ShapeKind.DECODE if tag.startswith("decode") \\
        else C.ShapeKind.PREFILL
    shape = C.ShapeConfig("s", kind, %(short)d if tag == "prefill_short"
                          else %(seq)d, b)
    mesh = [int(n) for n in ms.split("x")] if ms != "1x1" else []
    ns = (mesh[1] if b %% mesh[0] == 0 and b >= mesh[0]
          else mesh[0] * mesh[1]) if mesh else 1
    kw = {}
    if tag == "decode_a3":
        kw["a3"] = dataclasses.replace(C.A3Config.conservative(),
                                       select_shards=ns)
    if tag == "decode_block":
        kw["decode_block"] = 4
    if tag == "chunk":
        kw["prefill_chunk"] = %(chunk)d
    if tag == "gather":
        kw.update(gather_pages=32, page_size=16, kv_quant="int8")
    rec = run_cell(configs()[name], shape, mesh_shape=mesh, device="cpu",
                   verbose=False, **kw)
    out["/".join(map(str, (name, ms, b, tag)))] = [
        rec["flops_per_device"], rec["chips"], rec["collective_bytes"],
        rec["a3_mode"]]
print(json.dumps(out))
"""


def _dry_cells():
    return sorted({(n, "x".join(map(str, s)), b, t)
                   for n, s, b, ts in SERVE_CELLS.values()
                   for t in ts.split() if t != "chunk_a3"}
                  | {("tiny", "1x1", 8, t) for t in
                     ("prefill", "decode", "decode_block", "chunk")}
                  | {("tiny", "2x2", 8, "gather")})


def _start_python(code: str):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [SRC, os.path.dirname(os.path.abspath(__file__)),
         os.environ.get("PYTHONPATH", "")]))
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def serve_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_serve")
    cells = sorted({(n, s, b, " ".join(t for t in ts.split()
                                       if t != "chunk_a3"))
                    for n, s, b, ts in SERVE_CELLS.values()}
                   | {("tiny", (1, 1), 8, "prefill prefill_short decode "
                       "decode_a3 decode_block chunk"),
                      ("tiny", (1, 1), 1, "prefill decode"),
                      ("tiny-6h", (1, 1), 8, "prefill decode"),
                      ("moe", (1, 1), 8, "prefill decode"),
                      ("rg", (1, 1), 8, "prefill decode"),
                      ("xl", (1, 1), 8, "prefill decode")})
    # the reference's counts compile in a subprocess of their own, and the
    # port's dry run traces in another, while this one runs the
    # reference's dispatches and the ranks
    counting = start_with_devices(_JAX_FLOPS % dict(
        seq=SERVE_SEQ, chunk=CHUNK, short=DECODE_FROM - 8, cells=cells),
        devices=8)
    tracing = _start_python(_DRY % dict(
        seq=SERVE_SEQ, chunk=CHUNK, short=DECODE_FROM - 8,
        cells=_dry_cells()))
    need = {}
    for case, (name, _, batch, tags) in SERVE_CELLS.items():
        t, sel = need.setdefault((name, batch), (set(), set()))
        t.update(tags.split())
        sel.add(_ns(case))
    by_world = {4: ["combine_group", "gather_2x2"]}
    for case, (_, shape, _, _) in SERVE_CELLS.items():
        by_world.setdefault(shape[0] * shape[1], []).append(case)
    # each world's ranks start once the reference made their inputs
    _gather_inputs(d)
    ref, waits = {}, []
    for world, cases in sorted(by_world.items()):
        for case in cases:
            if case in SERVE_CELLS:
                key = SERVE_CELLS[case][0], SERVE_CELLS[case][2]
                if key not in ref:
                    ref[key] = _jax_inputs(d, *key, *need[key])
        waits.append(start_ranks(world, cases, d))
    for wait in waits:
        wait()
    out, err = counting.communicate(timeout=900)
    assert counting.returncode == 0, err[-3000:]
    flops = {}
    for ln in out.splitlines():
        if ln.startswith("FLOPS "):
            _, name, ms, b, tag, n = ln.split()
            flops[name, ms, int(b), tag] = float(n)
    out, err = tracing.communicate(timeout=900)
    assert tracing.returncode == 0, err[-3000:]
    dry = {tuple(k.split("/")[:2]) + (int(k.split("/")[2]),
                                      k.split("/")[3]): v
           for k, v in json.loads(out.strip().splitlines()[-1]).items()}
    return d, ref, flops, dry


def _ns(case):
    _, shape, batch, _ = SERVE_CELLS[case]
    return shape[1] if batch % shape[0] == 0 and batch >= shape[0] \
        else shape[0] * shape[1]


def _dispatches():
    """Every (case, dispatch) whose reference is the JAX single-device
    dispatch of the same inputs (``chunk_a3`` has a test of its own)."""
    return [(c, t) for c, (_, _, _, ts) in SERVE_CELLS.items()
            for t in ts.split() if t != "chunk_a3"]


@pytest.mark.parametrize("case,tag", _dispatches())
def test_mesh_dispatch_matches_single_device_reference(serve_runs, case,
                                                       tag):
    d, ref = serve_runs[:2]
    name, _, batch, _ = SERVE_CELLS[case]
    got, want = result(d, case), ref[name, batch]
    if tag == "decode_block":
        np.testing.assert_array_equal(got[f"{tag}/ring"],
                                      want["decode_block/ring"])
        np.testing.assert_array_equal(got[f"{tag}/carry"],
                                      want["decode_block/carry"])
    else:
        key = {"prefill": f"prefill/{_ns(case)}/logits",
               "decode_a3": f"decode_a3/{_ns(case)}/logits"}.get(
                   tag, f"{tag}/logits")
        np.testing.assert_allclose(got[f"{tag}/logits"], want[key],
                                   rtol=0, atol=_tol(name, want[key]))
    # every rank's share of the cache, and the A^3 sorted rows exactly
    assert float(got[f"{tag}/diff"].max()) <= TOL, got[f"{tag}/diff"]
    assert bool(got[f"{tag}/sorted_equal"].all())


def test_chunked_prefill_then_a3_decode_on_a_split_ring(serve_runs):
    """TINY on (2, 4), ``select_shards`` 4: two chunks of a chunked prefill
    with A^3, then the conservative decode step. One device sorts the
    whole ring after a chunk and its compact decode reads those columns
    as 4 blocks; each rank keeps its rows of that same sort (the rings
    gathered over the ring's ranks), so the rings, the sorted rows and
    the decode's logits are the reference's."""
    d, ref = serve_runs[:2]
    got, want = result(d, "serve_tiny_2x4"), ref["tiny", 8]
    assert float(got["chunk_a3/diff"].max()) <= TOL, got["chunk_a3/diff"]
    assert bool(got["chunk_a3/sorted_equal"].all())
    np.testing.assert_allclose(got["chunk_a3/logits"],
                               want["chunk_a3/logits"], rtol=0, atol=TOL)
    np.testing.assert_array_equal(got["chunk_a3/logits"].argmax(-1),
                                  want["chunk_a3/logits"].argmax(-1))


def test_chunked_prefill_then_a3_decode_on_one_device(serve_runs):
    """The same on one device, from the same parameters and inputs: the
    port sorts the whole ring after a chunk, as the reference does, and
    its compact decode reads those columns as 4 blocks, dropping the row
    ids past a block as the reference's scatter does: logits within 2e-5
    of the reference's own."""
    from repro_torch.config import A3Config
    from repro_torch.models import decoder
    from repro_torch.models.convert import params_from_numpy
    from test_torch_mesh_worker import configs, load_tree
    d, ref = serve_runs[:2]
    cfg = configs()["tiny"]
    model = params_from_numpy(load_tree(d / "init_tiny.npz"), cfg, "cpu")
    with np.load(d / f"{serve_inputs_name('tiny', 8)}_x.npz") as f:
        x = {k: torch.from_numpy(f[k]) for k in f.files}
    cache = decoder.init_cache(cfg, 8, SERVE_SEQ, a3=True, device="cpu")
    decoder.prefill_chunk(model, cfg, cache, x["tokens"][:, :CHUNK],
                          torch.zeros(8, dtype=torch.int32),
                          torch.full((8,), CHUNK, dtype=torch.int32), a3=True)
    decoder.prefill_chunk(model, cfg, cache, x["chunk_tokens"],
                          x["chunk_pos"], x["chunk_len"], a3=True)
    logits, _ = decoder.decode_step(
        model, cfg, cache, x["tokens"][:, 2 * CHUNK],
        x["chunk_pos"] + x["chunk_len"],
        a3=dataclasses.replace(A3Config.conservative(),
                               select_shards=_ns("serve_tiny_2x4")))
    want = ref["tiny", 8]["chunk_a3/logits"]
    np.testing.assert_allclose(logits.numpy()[:, :want.shape[-1]], want,
                               rtol=0, atol=TOL)


# the cells whose per-device count GSPMD splits into 1/devices of the
# one-device count; the others keep some work replicated there
_EXACT = {("tiny", 8): "prefill prefill_short decode decode_a3 "
                       "decode_block chunk", ("tiny-6h", 8): "prefill",
          ("tiny", 1): "decode", ("rg", 8): "prefill decode",
          ("xl", 8): "prefill decode"}


@pytest.mark.parametrize("case,tag", _dispatches())
def test_each_rank_does_the_reference_per_device_flops(serve_runs, case,
                                                       tag):
    d, _, jax_flops, _ = serve_runs
    name, shape, batch, _ = SERVE_CELLS[case]
    mesh = "x".join(map(str, shape))
    got = result(d, case)[f"{tag}/flops"]
    want = jax_flops[name, mesh, batch, tag]
    one = jax_flops[name, "1x1", batch, tag]
    if tag in _EXACT.get((name, batch), ""):
        assert want * shape[0] * shape[1] == one
        np.testing.assert_allclose(got, np.full_like(got, want), rtol=1e-6)
    elif name == "moe":
        # each rank runs its experts over its block of the capacity slots
        # and scores its block of the rows: no more than GSPMD's program
        # per device, and its count where GSPMD splits the cell into
        # 1/devices (test_torch_mesh_moe.py holds the port's count to
        # its single device's over the ranks)
        if want * shape[0] * shape[1] == one:
            np.testing.assert_allclose(got, np.full_like(got, want),
                                       rtol=1e-6)
        else:
            assert float(got.max()) <= want
    else:
        # GSPMD keeps part of this cell replicated; the port does no more
        assert want * shape[0] * shape[1] > one
        assert float(got.max()) <= want


@pytest.mark.parametrize("case,tag", _dispatches())
def test_dry_run_counts_what_the_rank_counts(serve_runs, case, tag):
    """The cell traced by ``repro_torch.launch.dryrun`` in a fake world of
    its size counts, as rank 0, what the gloo rank 0 counted running it;
    its mesh, its A^3 mode, and the combine's collectives where the
    mesh splits the cell."""
    d, _, _, dry = serve_runs
    name, shape, batch, _ = SERVE_CELLS[case]
    flops, chips, coll, a3 = dry[name, "x".join(map(str, shape)), batch,
                                 tag]
    got = result(d, case)[f"{tag}/flops"]
    assert flops == pytest.approx(float(got[0]), rel=1e-6)
    assert chips == shape[0] * shape[1]
    assert a3 == ("conservative" if tag == "decode_a3" else "off")
    assert coll > 0


@pytest.mark.parametrize("tag", ["prefill", "decode", "decode_block",
                                 "chunk"])
def test_one_device_dry_run_counts_the_reference(serve_runs, tag):
    """TINY's cells traced on one device count the reference's one-device
    ``dot_flops()`` of the same ``lower_*``, and move nothing."""
    _, _, jax_flops, dry = serve_runs
    flops, chips, coll, _ = dry["tiny", "1x1", 8, tag]
    assert flops == pytest.approx(jax_flops["tiny", "1x1", 8, tag],
                                  rel=1e-6)
    assert chips == 1 and coll == 0


def test_dry_run_gather_moves_bytes_and_does_no_product(serve_runs):
    flops, _, coll, _ = serve_runs[3]["tiny", "2x2", 8, "gather"]
    assert flops == 0 and coll > 0


@pytest.mark.parametrize("kind", ["none", "int8"])
def test_gather_fn_on_a_mesh_matches_the_reference(serve_runs, kind):
    """The warm-admission copy on (2, 2) from an fp and an int8 pool laid
    out as the rings: each rank's share of the lane's ring, its sorted
    columns (its rows of the whole ring's sort) and its watermark equal
    to the reference's, the sorted rows exactly."""
    d = serve_runs[0]
    got = result(d, "gather_2x2")
    assert float(got[f"{kind}/diff"].max()) <= TOL, got[f"{kind}/diff"]
    assert bool(got[f"{kind}/sorted_equal"].all())


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_serve_one")
    run_ranks(1, ["serve_one_rank"], d)
    return result(d, "serve_one_rank")


@pytest.mark.parametrize("mode", ["off", "conservative"])
def test_one_rank_mesh_serve_is_the_unsharded_serve(one_rank, mode):
    """On one rank the mesh path (the plan, its collectives, #1's partial
    softmax and its combine) gives the unsharded dispatches' numbers bit
    for bit: the card's [17b] holds phi4-mini-3.8b to the same."""
    assert bool(one_rank[f"{mode}/logits"])
    assert bool(one_rank[f"{mode}/tokens"])
    assert bool(one_rank[f"{mode}/cache"])
    assert (one_rank[f"{mode}/harvest"][:, 1:] >= 0).all()


# ---------------------------------------------------------------------------
# the combine of partial softmaxes (kernels/decode_attention/ops.py)
# ---------------------------------------------------------------------------

def _whole(q, k, v, mask, thr=None):
    from repro_torch.kernels.decode_attention import kernel as tk
    fused = tk.fused_plain(q, k, v, mask)
    rm = tk.rowmax_plain(q, k, mask)
    return fused, tk.attend_plain(q, k, v, mask, rm, threshold=thr)


def _rows_match(got, want, atol=1e-6):
    """NaN where ``want`` is NaN, all-zero rows where it has them, the
    rest within ``atol``."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal((got == 0).all(-1), (want == 0).all(-1))
    fin = ~np.isnan(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=atol)


@pytest.mark.parametrize("n", [2, 4, 8, 16])
@pytest.mark.parametrize("thr", [None, 3.0])
def test_combine_partials_over_slices_is_the_whole_ring(n, thr):
    """#1's plain version on ``n`` slices with its log-sum-exp, and #2 /
    #3 against the max over the slices with their row sums, combined on
    one device: the whole ring's output, including a NaN key (NaN rows),
    an empty slice (l == 0) and a ring masked everywhere (the -1e30 scores
    of a row with nothing kept: a zero row)."""
    from repro_torch.kernels.decode_attention import kernel as tk
    from repro_torch.kernels.decode_attention.ops import combine_partials
    from test_torch_mesh_worker import combine_inputs
    q, k, v, mask = combine_inputs()
    cut = lambda t: [c.contiguous() for c in t.chunk(n, 2)]  # noqa: E731
    parts = [tk.fused_plain(q, ks, vs, ms, partial=True)
             for ks, vs, ms in zip(cut(k), cut(v), cut(mask))]
    fused, attend = _whole(q, k, v, mask, thr)
    got = combine_partials([o for o, _ in parts], [s for _, s in parts])
    _rows_match(got, fused)
    assert torch.isnan(got[1]).any() and (got[0, 3] == 0).all()
    rm = torch.stack([tk.rowmax_plain(q, ks, ms) for ks, ms in
                      zip(cut(k), cut(mask))]).amax(0)
    parts = [tk.attend_plain(q, ks, vs, ms, rm, threshold=thr, partial=True)
             for ks, vs, ms in zip(cut(k), cut(v), cut(mask))]
    got = combine_partials([o for o, _ in parts], [s for _, s in parts],
                           stat="sum")
    _rows_match(got, attend)


def test_one_slice_combines_to_itself_bit_for_bit():
    """A ring held whole (one slice): the combine gives its output back
    exactly, for both statistics (the one-rank mesh path)."""
    from repro_torch.kernels.decode_attention import kernel as tk
    from repro_torch.kernels.decode_attention.ops import combine_partials
    from test_torch_mesh_worker import combine_inputs
    q, k, v, mask = combine_inputs()
    o, lse = tk.fused_plain(q, k, v, mask, partial=True)
    got = combine_partials(o, lse)
    assert torch.equal(torch.isnan(got), torch.isnan(o))
    assert torch.equal(got.nan_to_num(7.0), o.nan_to_num(7.0))
    rm = tk.rowmax_plain(q, k, mask)
    o, lsum = tk.attend_plain(q, k, v, mask, rm, threshold=3.0, partial=True)
    assert torch.equal(combine_partials(o, lsum, stat="sum"), o)


def test_combine_partials_over_gloo_ranks(serve_runs):
    """The same over 4 gloo ranks, each its slice of the ring (a NaN key on
    rank 2, an empty slice on rank 1): NaN rows kept through the
    all-reduces."""
    from test_torch_mesh_worker import combine_inputs
    d = serve_runs[0]
    got = result(d, "combine_group")
    q, k, v, mask = combine_inputs()
    fused, _ = _whole(q, k, v, mask)
    _rows_match(got["fused"], fused.numpy())
    for thr in (None, 3.0):
        _rows_match(got[f"attend_{thr}"], _whole(q, k, v, mask, thr)[1])
