"""The port's page store (``repro_torch.serve.page_store``) against the
JAX one: the same tree serializes to the same bytes in both packages
(float32, int8, int32, uint8, bool and bfloat16 leaves, nested dicts,
``None`` leaves and empty dicts), and each package's blob loads in the
other. Then the cases of ``tests/test_serve_l2_store.py:102-200`` on the
port: the round trip, card leaves read to the host, bfloat16, every
corruption mode raising ``IntegrityError``, LRU eviction under the byte
budget, a corrupt blob dropped and counted on ``get``. Also the mixers'
``dump_snapshot`` / ``load_snapshot`` round trip, the checkpoint's
``copy_into`` checks, and the ``Stager`` on the CPU (it hands the tree
back; ``chip_smoke.py`` phase [11] drives its uploads on the card).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.serve import page_store as jps  # noqa: E402
from repro_torch.config import BlockKind  # noqa: E402
from repro_torch.models.mixer import MIXERS  # noqa: E402
from repro_torch.serve.page_store import CheckpointError, IntegrityError, \
    PageStore, Stager, copy_into, deserialize_tree, serialize_tree  # noqa: E402,E501

from test_torch_helpers import N  # noqa: E402


def _trees(seed=0):
    """The same nested tree as numpy / jnp leaves (for the JAX package)
    and as torch leaves (for the port)."""
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal((2, 3, 4)).astype(np.float32)
    i8 = rng.integers(-128, 128, (2, 5)).astype(np.int8)
    i32 = rng.integers(-2**31, 2**31, (7,)).astype(np.int32)
    u8 = np.uint8(1)
    b1 = rng.random((3,)) > 0.5
    bf = rng.standard_normal((3, 4)).astype(np.float32)
    bf_j = jnp.asarray(bf, jnp.bfloat16)
    ref = {"page": {"seg0": {"k": f32, "k_scale": i32},
                    "seg2": {"q": i8, "mask": b1}},
           "sk": {"seg0": {"vals": bf_j}}, "meta": {"snap_valid": u8},
           "snap": {}, "none": None}
    port = {"page": {"seg0": {"k": torch.from_numpy(f32),
                              "k_scale": torch.from_numpy(i32)},
                     "seg2": {"q": torch.from_numpy(i8),
                              "mask": torch.from_numpy(b1)}},
            "sk": {"seg0": {"vals": torch.from_numpy(bf).to(torch.bfloat16)}},
            "meta": {"snap_valid": u8}, "snap": {}, "none": None}
    return ref, port


def test_same_tree_same_bytes_in_both_packages():
    ref, port = _trees()
    assert serialize_tree(port) == jps.serialize_tree(ref)
    # torch bf16 rounds to nearest even as jnp does: the bits agree
    ref2, port2 = _trees(seed=3)
    assert serialize_tree(port2) == jps.serialize_tree(ref2)


def test_blob_of_either_package_loads_in_the_other():
    ref, port = _trees(1)
    from_jax = deserialize_tree(jps.serialize_tree(ref))
    from_port = jps.deserialize_tree(serialize_tree(port))
    assert set(from_jax) == set(from_port) == {"page", "sk", "meta"}
    for tree in (from_jax, from_port):
        assert set(tree["page"]) == {"seg0", "seg2"}
    assert from_jax["sk"]["seg0"]["vals"].dtype == torch.bfloat16
    assert from_port["sk"]["seg0"]["vals"].dtype == jnp.bfloat16
    for path in (("page", "seg0", "k"), ("page", "seg0", "k_scale"),
                 ("page", "seg2", "q"), ("page", "seg2", "mask"),
                 ("sk", "seg0", "vals"), ("meta", "snap_valid")):
        a, b, want_t, want_j = from_jax, from_port, port, ref
        for p in path:
            a, b, want_t, want_j = a[p], b[p], want_t[p], want_j[p]
        assert isinstance(a, torch.Tensor)
        np.testing.assert_array_equal(N(a), N(want_t))
        np.testing.assert_array_equal(np.asarray(b, np.float64),
                                      np.asarray(want_j, np.float64))
        assert N(a).dtype == np.asarray(N(want_t)).dtype


# ---------------------------------------------------------------------------
# tests/test_serve_l2_store.py:102-200 on the port
# ---------------------------------------------------------------------------

def test_store_blob_roundtrip_nested_mixed_dtypes():
    tree = {"page": {"kv0": torch.arange(24, dtype=torch.float32)
                     .reshape(2, 3, 4),
                     "scale": torch.ones((2, 1)),
                     "q": torch.arange(6, dtype=torch.int8).reshape(2, 3)},
            "meta": {"snap_valid": np.uint8(1)},
            "snap": {},                         # empty dict -> absent
            "sk": None}                         # None leaf -> absent
    blob = serialize_tree(tree)
    out = deserialize_tree(blob)
    assert set(out) == {"page", "meta"}
    for k in ("kv0", "scale", "q"):
        assert torch.equal(out["page"][k], tree["page"][k])
        assert out["page"][k].dtype == tree["page"][k].dtype
    assert int(out["meta"]["snap_valid"]) == 1
    assert out["meta"]["snap_valid"].dtype == torch.uint8
    assert serialize_tree(tree) == blob         # deterministic bytes


def test_store_blob_numpy_leaves_come_back_as_torch():
    out = deserialize_tree(serialize_tree(
        {"x": np.arange(8, dtype=np.float32)}))
    assert isinstance(out["x"], torch.Tensor) and out["x"].is_cpu
    assert torch.equal(out["x"], torch.arange(8, dtype=torch.float32))


def test_store_blob_roundtrips_bfloat16_leaves():
    """bfloat16 moves as raw 16-bit words under the tag ``bfloat16``:
    every bf16 cache checkpoints through this path, and no ml_dtypes is
    needed to read it back."""
    x = torch.arange(12, dtype=torch.bfloat16).reshape(3, 4) / 7
    blob = serialize_tree({"x": x})
    assert b'"dtype": "bfloat16"' in blob
    out = deserialize_tree(blob)
    assert out["x"].dtype == torch.bfloat16
    assert torch.equal(out["x"].view(torch.int16), x.view(torch.int16))


def test_store_blob_verification_catches_every_corruption_mode():
    blob = serialize_tree({"a": torch.arange(10, dtype=torch.float32)})
    with pytest.raises(IntegrityError):         # truncated header
        deserialize_tree(blob[:4])
    with pytest.raises(IntegrityError):         # truncated payload
        deserialize_tree(blob[:-3])
    with pytest.raises(IntegrityError):         # bad magic
        deserialize_tree(b"XXXX" + blob[4:])
    with pytest.raises(IntegrityError):         # flipped payload byte
        deserialize_tree(blob[:-1] + bytes([blob[-1] ^ 0xFF]))
    with pytest.raises(IntegrityError):         # flipped manifest byte
        i = 20
        deserialize_tree(blob[:i] + bytes([blob[i] ^ 0xFF]) + blob[i + 1:])
    with pytest.raises(IntegrityError):         # trailing bytes
        deserialize_tree(blob + b"\x00")


def test_store_unknown_dtype_tag_is_an_integrity_error():
    """A manifest naming a dtype neither package writes (checksum
    intact) is refused, as the reference refuses it."""
    import json
    import struct
    import zlib
    mbytes = json.dumps([{"key": "x", "dtype": "float8_e4m3",
                          "shape": [2]}], sort_keys=True).encode()
    payload = b"\x00\x00"
    crc = zlib.crc32(payload, zlib.crc32(mbytes))
    blob = struct.pack("<4sII", b"A3L2", crc, len(mbytes)) + mbytes + payload
    with pytest.raises(IntegrityError, match="unknown dtype"):
        deserialize_tree(blob)


def test_store_lru_eviction_under_byte_budget():
    stats = {}
    one = len(serialize_tree({"x": torch.zeros(16)}))
    st = PageStore(max_bytes=3 * one, stats=stats)
    for i in range(3):
        assert st.put((i,), {"x": torch.full((16,), float(i))})
    assert len(st) == 3 and st.bytes_used == 3 * one
    st.get((0,))                    # touch: (1,) becomes LRU
    assert st.put((9,), {"x": torch.zeros(16)})
    assert (1,) not in st and (0,) in st
    assert stats["l2_evictions"] == 1
    # a blob bigger than the whole budget is rejected, not stored
    assert not st.put((7,), {"x": torch.zeros(1024)})
    assert (7,) not in st
    st.pop((0,))                    # promotion removes the blob
    assert (0,) not in st
    with pytest.raises(ValueError):
        PageStore(max_bytes=0)


def test_store_corrupt_blob_dropped_and_counted_on_get():
    stats = {}
    st = PageStore(max_bytes=1 << 20, stats=stats)
    st.put((1, 2, 3), {"x": torch.arange(4, dtype=torch.float32)})
    assert st.corrupt((1, 2, 3))
    assert st.get((1, 2, 3)) is None
    assert (1, 2, 3) not in st      # dropped at read time
    assert stats["l2_integrity_drops"] == 1
    assert stats["l2_hits"] == 0
    assert st.get((9,)) is None     # plain miss: not an integrity drop
    assert stats["l2_integrity_drops"] == 1
    assert not st.corrupt((9,))


def test_store_corrupt_flips_the_reference_byte():
    """``corrupt`` flips the same byte in both packages, so a chaos run's
    corrupted blobs are the same bytes."""
    ref, port = _trees(2)
    js, ts = jps.PageStore(1 << 20), PageStore(1 << 20)
    js.put((5,), ref)
    ts.put((5,), port)
    js.corrupt((5,))
    ts.corrupt((5,))
    assert dict(ts.raw_items()) == dict(js.raw_items())


# ---------------------------------------------------------------------------
# the durable-state hooks around the store
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", [BlockKind.RGLRU, BlockKind.MLSTM,
                                  BlockKind.SLSTM, BlockKind.ATTENTION])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mixer_snapshot_dump_load_bit_for_bit(kind, dtype):
    g = torch.Generator().manual_seed(0)
    snap = {"h": torch.randn((3, 1, 8), generator=g).to(dtype),
            "m": torch.full((3, 1, 4), float("-inf")).to(dtype),
            "conv": torch.randn((3, 1, 2, 8), generator=g).to(dtype)}
    host = MIXERS[kind].dump_snapshot(snap)
    snap["h"].zero_()                   # the dump is a copy, not a view
    back = MIXERS[kind].load_snapshot(
        deserialize_tree(serialize_tree(host)), "cpu")
    assert set(back) == set(host)
    for k, v in host.items():
        assert back[k].dtype == dtype and v.dtype == dtype
        assert torch.equal(back[k].view(torch.int16 if dtype == torch.bfloat16
                                        else torch.int32),
                           v.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32))
    assert not torch.equal(host["h"], snap["h"])


def test_copy_into_checks_keys_shapes_and_dtypes():
    dst = {"seg0": {"k": torch.zeros((2, 3)), "pos": torch.zeros(
        (2,), dtype=torch.int32)}}
    src = {"seg0": {"k": torch.ones((2, 3)), "pos": torch.arange(
        2, dtype=torch.int32)}}
    copy_into(dst, src, "cache")
    assert torch.equal(dst["seg0"]["k"], torch.ones((2, 3)))
    with pytest.raises(CheckpointError, match="lacks cache/seg0/pos"):
        copy_into(dst, {"seg0": {"k": torch.ones((2, 3))}}, "cache")
    with pytest.raises(CheckpointError, match="cache/seg0/k"):
        copy_into(dst, {"seg0": {"k": torch.ones((2, 4)),
                                 "pos": src["seg0"]["pos"]}}, "cache")
    with pytest.raises(CheckpointError, match="cache/seg0/k"):
        copy_into(dst, {"seg0": {"k": torch.ones((2, 3), dtype=torch.float64),
                                 "pos": src["seg0"]["pos"]}}, "cache")


def test_stager_hands_cpu_trees_back():
    tree = {"page": {"seg0": {"k": torch.ones(2)}}, "snap": {}}
    assert Stager("cpu").stage(tree) is tree
