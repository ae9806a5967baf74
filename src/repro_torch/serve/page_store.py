"""Durable page store of the port (PyTorch port of
``repro.serve.page_store``): the checksummed host-RAM L2 tier behind the
paged prefix cache, plus the blob (de)serialization the engine
checkpoint reuses.

The device pool bounds how many shared prefixes the cache holds; a
host-RAM tier keeps far more. It is only trustworthy if a spilled page
that comes back corrupt degrades to cold prefill, never to wrong tokens,
so every blob is verified on every restore:

* **Blob format** (``serialize_tree`` / ``deserialize_tree``), byte for
  byte the reference's: a nested dict of tensors flattens to a JSON
  manifest (key paths, dtypes, shapes; ``json.dumps(..., sort_keys=True)``)
  plus the concatenated raw bytes, after a ``<4sII`` header (the magic
  ``A3L2``, a ``zlib.crc32`` over manifest then payload, the manifest's
  length). Dtype tags are numpy's ``dtype.str`` (``<f4``, ``|i1``, ...)
  and the bare name ``bfloat16``, so the same tree gives the same bytes
  in both packages and a blob of either loads in the other. bfloat16
  moves as raw 16-bit words (``view(torch.int16)`` out, ``view(
  torch.bfloat16)`` back): no ``ml_dtypes`` is needed.
  ``deserialize_tree`` recomputes the checksum and raises
  :class:`IntegrityError` on any mismatch, truncation or malformed
  header, and returns CPU torch tensors.
* **:class:`PageStore`** holds blobs keyed by the full token path of the
  evicted trie node, LRU-evicted under a byte budget (``l2_bytes``).
  ``get`` verifies: a corrupt blob is dropped at read time and counted in
  ``stats["l2_integrity_drops"]``. Promotion ``pop``s the blob (a page
  lives in exactly one tier).
* **:class:`Stager`** uploads a promoted page through pinned host buffers
  (``.to(device, non_blocking=True)``) and records a CUDA event after
  each upload. Two buffers rotate; before the host overwrites one it waits on
  that buffer's event, so it never rewrites a page whose host-to-device
  copy is still running. The upload overlaps the warm gather behind it
  and makes no synchronizing call.
"""
from __future__ import annotations

import collections
import json
import struct
import zlib
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["IntegrityError", "CheckpointError", "PageStore", "Stager",
           "copy_into", "serialize_tree", "deserialize_tree"]

_MAGIC = b"A3L2"
_HEADER = struct.Struct("<4sII")     # magic, crc32, manifest length
_BF16 = "bfloat16"


class IntegrityError(RuntimeError):
    """A serialized blob failed verification (checksum mismatch,
    truncation, or malformed header): the data is lost, never
    approximately right."""


class CheckpointError(RuntimeError):
    """An engine checkpoint directory failed verification or does not
    match the restoring configuration."""


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out: List[Tuple[str, Any]] = []
        for k in sorted(tree):
            out.extend(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    if tree is None:
        return []
    return [(prefix[:-1], tree)]


def _host_leaf(leaf: Any) -> Tuple[str, np.ndarray]:
    """A leaf (torch tensor on any device, numpy array or scalar) -> (its
    dtype tag, a C-contiguous host array of its bytes)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return _BF16, t.view(torch.int16).numpy()
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if arr.dtype.kind == "V":
        raise TypeError(f"cannot serialize dtype {arr.dtype}")
    return arr.dtype.str, np.ascontiguousarray(arr)


def serialize_tree(tree: Any) -> bytes:
    """Nested dict of tensors -> self-describing checksummed bytes. Leaves
    may be torch tensors (card leaves are copied to the host here) or
    numpy arrays; ``None`` leaves and empty dicts serialize to nothing
    and restore as absent keys."""
    manifest = []
    chunks = []
    for key, leaf in _flatten(tree):
        tag, arr = _host_leaf(leaf)
        manifest.append({"key": key, "dtype": tag,
                         "shape": list(arr.shape)})
        chunks.append(arr.tobytes())
    mbytes = json.dumps(manifest, sort_keys=True).encode()
    payload = b"".join(chunks)
    crc = zlib.crc32(payload, zlib.crc32(mbytes))
    return _HEADER.pack(_MAGIC, crc, len(mbytes)) + mbytes + payload


def _np_dtype(tag: str) -> np.dtype:
    """The numpy dtype a tag names (bfloat16: its 16-bit words)."""
    if tag == _BF16:
        return np.dtype(np.int16)
    try:
        dt = np.dtype(tag)
    except TypeError:
        dt = None
    if dt is None or dt.kind == "V":
        raise IntegrityError(f"unknown dtype {tag!r} in manifest")
    return dt


def deserialize_tree(blob: bytes) -> Dict[str, Any]:
    """Verified inverse of :func:`serialize_tree` (CPU torch leaves).
    Raises :class:`IntegrityError` unless the blob's checksum, header
    and per-leaf byte counts all hold."""
    if len(blob) < _HEADER.size:
        raise IntegrityError(f"blob truncated: {len(blob)} bytes < "
                             f"{_HEADER.size}-byte header")
    magic, crc, mlen = _HEADER.unpack_from(blob)
    if magic != _MAGIC:
        raise IntegrityError(f"bad magic {magic!r}")
    body = memoryview(blob)[_HEADER.size:]
    if len(body) < mlen:
        raise IntegrityError("blob truncated inside manifest")
    if zlib.crc32(body) != crc:
        raise IntegrityError("checksum mismatch")
    try:
        manifest = json.loads(bytes(body[:mlen]).decode())
    except ValueError as e:
        raise IntegrityError(f"malformed manifest: {e}") from None
    tree: Dict[str, Any] = {}
    off = mlen
    for entry in manifest:
        dtype = _np_dtype(entry["dtype"])
        shape = tuple(entry["shape"])
        n = dtype.itemsize * int(np.prod(shape, dtype=np.int64))
        if off + n > len(body):
            raise IntegrityError("blob truncated inside payload")
        arr = np.frombuffer(body[off:off + n], dtype=dtype).reshape(shape)
        off += n
        leaf = torch.from_numpy(arr.copy())
        if entry["dtype"] == _BF16:
            leaf = leaf.view(torch.bfloat16)
        node = tree
        *parents, name = entry["key"].split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    if off != len(body):
        raise IntegrityError(f"{len(body) - off} trailing bytes")
    return tree


def copy_into(dst: Dict[str, Any], src: Dict[str, Any], what: str) -> None:
    """Copy a deserialized tree into the live tensors of ``dst`` (same
    keys), in place on their device, each dtype bit for bit. Raises
    :class:`CheckpointError` on a missing leaf, a shape or a dtype that
    does not match."""
    for k, d in dst.items():
        s = src.get(k) if isinstance(src, dict) else None
        if s is None:
            raise CheckpointError(f"checkpoint lacks {what}/{k}")
        if isinstance(d, dict):
            copy_into(d, s, f"{what}/{k}")
            continue
        if s.dtype != d.dtype or s.shape != d.shape:
            raise CheckpointError(
                f"{what}/{k}: checkpoint holds {s.dtype} "
                f"{tuple(s.shape)}, the engine {d.dtype} {tuple(d.shape)}")
        d.copy_(s)


class Stager:
    """Double-buffered upload of promoted L2 pages (see the module
    docstring): each ``stage`` fills one of two sets of pinned host
    buffers and copies it to ``device`` with ``non_blocking=True``,
    recording a CUDA event after the copies; the set is refilled only
    after that event has completed, so staging promotion N+1 overlaps
    the gather behind promotion N. On the CPU the tree is returned as
    it is."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._bufs: List[Dict[str, torch.Tensor]] = [{}, {}]
        self._done: List[Optional[Any]] = [None, None]
        self._i = 0

    def stage(self, tree: Any) -> Any:
        if self.device.type != "cuda":
            return tree
        self._i ^= 1
        bufs = self._bufs[self._i]
        if self._done[self._i] is not None:
            # the copy that last read these buffers must have finished
            self._done[self._i].synchronize()

        def up(x, key):
            if isinstance(x, dict):
                return {k: up(v, f"{key}/{k}") for k, v in x.items()}
            buf = bufs.get(key)
            if buf is None or buf.shape != x.shape or buf.dtype != x.dtype:
                buf = bufs[key] = torch.empty(x.shape, dtype=x.dtype,
                                              pin_memory=True)
            buf.copy_(x)
            return buf.to(self.device, non_blocking=True)

        staged = up(tree, "")
        done = torch.cuda.Event()
        done.record()
        self._done[self._i] = done
        return staged


_STAT_KEYS = ("l2_spills", "l2_hits", "l2_evictions",
              "l2_integrity_drops")


class PageStore:
    """Byte-budgeted LRU host store of checksummed blobs, keyed by the
    evicted node's full token path. ``stats`` may be externally owned
    (the prefix cache passes the engine's dict)."""

    def __init__(self, max_bytes: int,
                 stats: Optional[Dict[str, int]] = None):
        if max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1 for a PageStore, "
                             f"got {max_bytes} (use l2_bytes=0 to "
                             f"disable the L2 tier)")
        self.max_bytes = int(max_bytes)
        self._blobs: "collections.OrderedDict[Tuple[int, ...], bytes]" = \
            collections.OrderedDict()
        self._bytes = 0
        self.stats = stats if stats is not None else {}
        for k in _STAT_KEYS:
            self.stats.setdefault(k, 0)

    # -- capacity ------------------------------------------------------------
    @property
    def bytes_used(self) -> int:
        return self._bytes

    def _reserve(self, need: int) -> bool:
        """Evict LRU blobs until ``need`` bytes fit; False if ``need``
        alone exceeds the budget (the blob is dropped, not stored: a lost
        L2 entry only costs a cold prefill later)."""
        if need > self.max_bytes:
            return False
        while self._bytes + need > self.max_bytes:
            _, blob = self._blobs.popitem(last=False)
            self._bytes -= len(blob)
            self.stats["l2_evictions"] += 1
        return True

    # -- store / load --------------------------------------------------------
    def put(self, key: Tuple[int, ...], tree: Any) -> bool:
        """Serialize and store a demoted node's payload; True if it was
        admitted under the byte budget."""
        blob = serialize_tree(tree)
        self.discard(key)
        if not self._reserve(len(blob)):
            return False
        self._blobs[key] = blob
        self._bytes += len(blob)
        self.stats["l2_spills"] += 1
        return True

    def put_raw(self, key: Tuple[int, ...], blob: bytes) -> bool:
        """Re-admit an already-serialized blob (checkpoint restore);
        verification stays lazy: ``get`` checks the crc as usual."""
        self.discard(key)
        if not self._reserve(len(blob)):
            return False
        self._blobs[key] = bytes(blob)
        self._bytes += len(blob)
        return True

    def get(self, key: Tuple[int, ...]) -> Optional[Dict[str, Any]]:
        """Verified load. None on a miss; a blob failing verification is
        dropped here (the caller cold-prefills) and counted in
        ``stats["l2_integrity_drops"]``."""
        blob = self._blobs.get(key)
        if blob is None:
            return None
        self._blobs.move_to_end(key)
        try:
            tree = deserialize_tree(blob)
        except IntegrityError:
            self.discard(key)
            self.stats["l2_integrity_drops"] += 1
            return None
        self.stats["l2_hits"] += 1
        return tree

    def pop(self, key: Tuple[int, ...]) -> None:
        """Remove a promoted blob (a page lives in exactly one tier)."""
        self.discard(key)

    def discard(self, key: Tuple[int, ...]) -> None:
        blob = self._blobs.pop(key, None)
        if blob is not None:
            self._bytes -= len(blob)

    def clear(self) -> None:
        self._blobs.clear()
        self._bytes = 0

    # -- introspection / fault injection -------------------------------------
    def __contains__(self, key: Tuple[int, ...]) -> bool:
        return key in self._blobs

    def __len__(self) -> int:
        return len(self._blobs)

    def keys(self) -> Iterable[Tuple[int, ...]]:
        return self._blobs.keys()

    def raw_items(self) -> Iterable[Tuple[Tuple[int, ...], bytes]]:
        """(key, blob) pairs for the engine checkpoint (blobs are written
        as they are: they carry their own checksums)."""
        return self._blobs.items()

    def corrupt(self, key: Tuple[int, ...]) -> bool:
        """Flip the last payload byte of a stored blob (the chaos
        ``restore_corrupt`` site and the tests' bit-rot model). True if
        the key was present."""
        blob = self._blobs.get(key)
        if blob is None:
            return False
        self._blobs[key] = blob[:-1] + bytes([blob[-1] ^ 0xFF])
        return True
