"""Paged prefix cache of the port (PyTorch port of the device tier of
``repro.serve.prefix_cache``): shared-prefix reuse across every mixer
kind.

An engine without prefix reuse prefills identical prompt prefixes (a
shared system prompt, a few-shot header, a multi-turn history) once per
request. This cache records admitted prompts in fixed-size **pages** of
a device pool and indexes them with a host-side **radix trie** whose
nodes own immutable pages plus the mixer state at their boundary::

    root --[tok 0..ps)--> node(page 0, snap@ps)
                            |--[tok ps..2ps)--> node(page 1, snap@2ps)
                            `--[tok' ps..2ps)-> node(page 7, snap@2ps)
                                                (divergent sibling: COW)

* **Pages** live in the pool of ``decoder.init_page_pool``: a logical
  page spans ``page_size`` positions of every segment; attention
  segments keep those positions' K/V ring rows, recurrent segments keep
  nothing per token (their state is a carry).
* **Snapshots.** The engine clamps a recorded prompt's chunks to end on
  page boundaries, so after a chunk the lane's mixer state *is* the
  boundary state: the recurrent carries are copied there. A^3's sorted
  key columns are a whole-ring property, copied once per recorded
  prompt at its trie leaf and *sliced* to the matched boundary at
  restore (``slice_sorted_keys``), not re-sorted.
* **Warm admission** walks the trie over the prompt's pages and restores
  every matched slot in one call (``gather_into``, counted once in
  ``gather_dispatches`` however many slots it admits): ring rows from
  pages, carries from the matched node's snapshot, the sorted columns and
  the ``sorted_upto`` watermark at the boundary. Only the suffix is
  prefilled, and at least one token of it always is (a full-prefix hit
  stops one page short): it yields the next-token logits.
* **Copy-on-write** is structural: pool pages are immutable (the gather
  writes the slot's ring, never the pool), and a request diverging
  mid-page matches up to the last shared boundary and records its own
  sibling pages from there.
* **Eviction** is LRU over childless, unreferenced nodes under the
  ``cache_pages`` budget; a leaf's sorted-key snapshot is charged in
  pages and freed with it. Nodes pinned by an admission or a recording
  slot are never evicted.
* **Host-RAM L2 tier** (``l2_bytes > 0``): eviction *demotes* instead of
  only freeing. The node's pool page (K/V rows, int8 scales), recurrent
  carry snapshot and A^3 sorted-key leaf snapshot become one checksummed
  blob in a :class:`~repro_torch.serve.page_store.PageStore`, read from
  the card in one blocking device-to-host copy per node
  (``demote_reads``, ``demote_read_ns``). ``lookup`` extends a stalled
  trie walk through L2: each continuing page found there is *promoted*
  back (blob verified, a device page allocated, which may itself demote
  an LRU victim, the arrays staged through the pinned double buffer of
  :class:`~repro_torch.serve.page_store.Stager` and inserted into the
  pool, the trie node re-created), with no synchronizing call. A
  checksum mismatch or a malformed payload drops that node only back to
  cold prefill (``stats["l2_integrity_drops"]``); a device or runtime
  error propagates.
* **int8 pools** (``kv_quant="int8"``) store pages as int8 with one
  float32 scale per (layer, page, kv head) and sorted-key snapshots with
  one per sorted column; the gather dequantizes to the ring's dtype.

Every snapshot and pool write is a copy: a view of the live cache would
change as the slot goes on prefilling or decoding. The trie and the heap
are host Python; the index arrays of each copy are uploaded as the
engine uploads its control words (pinned memory, ``non_blocking``), so
``gather_into``, ``record_boundary``, ``record_final`` and a promotion's
staging and insert make no synchronizing CUDA call.

``dump_state`` / ``load_state`` carry the trie, the pool and the
snapshots through the engine checkpoint.
"""
from __future__ import annotations

import collections
import heapq
import itertools
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import KV_QUANTS, BlockKind, ModelConfig
from repro_torch.core.quantization import quantize_int8_block
from repro_torch.models import decoder
from repro_torch.models.mixer import FULL_WINDOW, MIXERS, build_segments, \
    cache_len_for
from repro_torch.serve.page_store import IntegrityError, PageStore, Stager, \
    copy_into

STAT_KEYS = ("prefix_hits", "prefix_tokens_reused", "gather_dispatches",
             "pages_recorded", "pages_evicted", "l2_spills", "l2_hits",
             "l2_evictions", "l2_integrity_drops")


def gather_fn(segs, a3: bool, cache, pool, si: int, t: int, idx, snaps,
              sk_snaps) -> None:
    """The warm-admission copy of one slot, in place: matched pages ->
    the slot's rings, boundary snapshot -> recurrent carries, sorted-key
    slice (or a sort of the gathered ring) and watermark ``t`` -> A^3
    state."""
    for i, seg in enumerate(segs):
        name = f"seg{i}"
        mixer = MIXERS[seg.kind]
        if seg.kind == BlockKind.ATTENTION:
            ids = idx[name]
            mixer.gather_pages(cache[name], pool[name], si, t, ids["page"],
                               ids["off"], ids["valid"], a3=a3,
                               sk_snap=sk_snaps.get(name))
        else:
            mixer.restore_state(cache[name], snaps[name], si)


def gather_many_fn(segs, a3: bool, cache, pool, packed) -> None:
    """Warm-admit every packed slot: :func:`gather_fn` once each."""
    for e in packed:
        gather_fn(segs, a3, cache, pool, e["si"], e["t"], e["idx"],
                  e["snaps"], e["sk"])


def _host_tree(tree):
    """Every tensor of a nested dict on the card -> the same dict on the
    host, read in ONE device-to-host copy (the leaves are packed into one
    byte buffer first). CPU trees come back as they are."""
    flat: List[torch.Tensor] = []

    def index(x):
        if isinstance(x, dict):
            return {k: index(v) for k, v in x.items()}
        flat.append(x)
        return len(flat) - 1

    where = index(tree)
    if not flat or not flat[0].is_cuda:
        return tree
    raw = [t.contiguous().reshape(-1).view(torch.uint8) for t in flat]
    host = torch.cat(raw).cpu()
    parts, off = [], 0
    for t, r in zip(flat, raw):
        n = r.numel()
        parts.append(host[off:off + n].clone().view(t.dtype).reshape(t.shape))
        off += n

    def build(x):
        return ({k: build(v) for k, v in x.items()} if isinstance(x, dict)
                else parts[x])
    return build(where)


def _flag(x) -> bool:
    """A payload's one-element flag (``meta/snap_valid``) -> bool."""
    if not isinstance(x, torch.Tensor) or x.numel() != 1:
        raise ValueError(f"malformed L2 flag {x!r}")
    return bool(int(x.reshape(-1)[0]))


class _TrieNode:
    """One page: ``tokens`` (the edge label, ``page_size`` token ids),
    the owned pool ``page_id``, and the mixer-state snapshot at ``end``
    (the boundary this node reaches)."""

    __slots__ = ("parent", "tokens", "end", "children", "page_id",
                 "snap", "snap_valid", "sk_snap", "sk_pages", "refs",
                 "last_used")

    def __init__(self, parent: Optional["_TrieNode"],
                 tokens: Tuple[int, ...], end: int):
        self.parent = parent
        self.tokens = tokens
        self.end = end
        self.children: Dict[Tuple[int, ...], "_TrieNode"] = {}
        self.page_id = -1
        self.snap: Any = {}
        # whether a match may end here: interior pages of a multi-page
        # chunk are recorded without a boundary state (the carry exists
        # only at the chunk's end, and a sliding ring captured after the
        # chunk may have dropped rows an interior restore needs).
        # Global-attention-only stacks match at any page; the others
        # stop at chunk-end (snap_valid) nodes.
        self.snap_valid = False
        self.sk_snap: Optional[Dict[str, Any]] = None
        self.sk_pages: List[int] = []   # budget pages charged for sk_snap
        self.refs = 0
        self.last_used = 0


class PrefixCache:
    """Host-side block table + device page pool + radix trie.

    Built by ``ServeEngine`` when ``cache_pages > 0``; usable alone
    against any ``decoder.init_cache`` dict on ``device``. ``stats`` may
    be the engine's dict: the cache counts ``prefix_hits``,
    ``prefix_tokens_reused``, ``gather_dispatches``, ``pages_recorded``
    and ``pages_evicted`` in it, and with the L2 tier ``l2_spills``,
    ``l2_hits``, ``l2_evictions`` and ``l2_integrity_drops``."""

    def __init__(self, cfg: ModelConfig, *, max_len: int, page_size: int,
                 cache_pages: int, a3: bool = False, dtype=None,
                 kv_quant: str = "none", l2_bytes: int = 0,
                 stats: Optional[Dict[str, int]] = None, device="cuda"):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if cache_pages < 1:
            raise ValueError(
                f"cache_pages must be >= 1 for a PrefixCache, got "
                f"{cache_pages} (use ServeConfig.cache_pages=0 to disable)")
        if kv_quant not in KV_QUANTS:
            raise ValueError(
                f"kv_quant must be 'none' or 'int8', got {kv_quant!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_len = int(max_len)
        self.page_size = int(page_size)
        self.capacity = int(cache_pages)
        self.a3 = bool(a3)
        self.kv_quant = kv_quant
        self.segs = build_segments(cfg)
        # ring widths of the attention segments (the pool mirrors these)
        self._widths = {f"seg{i}": cache_len_for(seg, max_len)
                        for i, seg in enumerate(self.segs)
                        if seg.kind == BlockKind.ATTENTION}
        self._sk_widths = {
            name: w for name, w in self._widths.items()
            if self.a3 and self.segs[int(name[3:])].window >= FULL_WINDOW}
        # a leaf's sorted-key snapshot holds two whole-ring arrays per
        # sorted segment (about a page's k + v per row), so it is charged
        # sum(w) / page_size budget pages: cache_pages bounds all the
        # device memory the trie holds
        self._sk_cost = (-(-sum(self._sk_widths.values())
                           // self.page_size) if self._sk_widths else 0)
        self._has_rec = any(s.kind != BlockKind.ATTENTION for s in self.segs)
        # page-granular match ends are safe only when every ring spans
        # max_len and nothing is recurrent: a sliding ring is captured
        # after the chunk, so an interior page's early rows may be gone
        self._page_terminals = (not self._has_rec and all(
            w >= self.max_len for w in self._widths.values()))
        self.pool = decoder.init_page_pool(cfg, cache_pages, page_size,
                                           dtype=dtype, a3=a3,
                                           kv_quant=kv_quant,
                                           device=self.device)
        self.root = _TrieNode(None, (), 0)
        self._free: List[int] = list(range(cache_pages))
        self._nodes: set = set()
        self._clock = 0
        # lazy-deletion LRU heap of (last_used, seq, node): pushed on
        # every touch and whenever a node may have become evictable;
        # stale entries are skipped at pop
        self._heap: List[Tuple[int, int, _TrieNode]] = []
        self._seq = itertools.count()
        self.stats = stats if stats is not None else {}
        for k in STAT_KEYS:
            self.stats.setdefault(k, 0)
        # host-RAM L2 tier: eviction demotes checksummed blobs here
        # instead of only freeing (0 = free on evict)
        if int(l2_bytes) < 0:
            raise ValueError(f"l2_bytes must be >= 0, got {l2_bytes} "
                             f"(0 disables the L2 tier)")
        self.l2: Optional[PageStore] = (
            PageStore(int(l2_bytes), stats=self.stats)
            if int(l2_bytes) > 0 else None)
        self._stager = Stager(self.device)
        # chaos hook: called with the blob key before each L2 restore;
        # True corrupts the blob first (the restore_corrupt site)
        self.l2_fault_hook: Optional[Any] = None
        # the engine's telemetry bundle (None = off): page and L2 events
        # on the trace's "cache" track
        self.tm: Optional[Any] = None
        # the demotions' blocking device-to-host reads: count and wall ns
        self.demote_reads = 0
        self.demote_read_ns = 0

    # -- device copies -------------------------------------------------------
    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host index array -> the pool's device, without a blocking copy
        (a pinned staging buffer on the card)."""
        t = torch.from_numpy(arr)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _record_page(self, cache: Dict[str, Any], si: int, page_id: int,
                     boundary: int) -> None:
        """Copy the page of lane ``si``'s rings ending at ``boundary``
        into pool page ``page_id``."""
        ps = self.page_size
        p = np.arange(boundary - ps, boundary)
        dev = {}
        for w in set(self._widths.values()):
            a = self._upload(np.stack([p % w, p >= boundary - w]))
            dev[w] = (a[0], a[1] > 0)
        for name, w in self._widths.items():
            rows, valid = dev[w]
            MIXERS[BlockKind.ATTENTION].write_page(
                self.pool[name], cache[name], si, page_id, rows, valid)

    def _snapshot(self, cache: Dict[str, Any], si: int) -> Dict[str, Any]:
        """Boundary snapshot: lane ``si``'s carry of every recurrent
        segment (copies)."""
        return {f"seg{i}": MIXERS[seg.kind].snapshot_state(
                    cache[f"seg{i}"], si)
                for i, seg in enumerate(self.segs)
                if seg.kind != BlockKind.ATTENTION}

    def _sk_snapshot(self, cache: Dict[str, Any], si: int
                     ) -> Dict[str, Any]:
        """Leaf snapshot of lane ``si``'s A^3 sorted columns (copies).
        On an int8 pool the values are stored int8 with one float32
        scale per sorted column (axis ``w`` of ``[L, H, w, d]``):
        rounding is monotone, so each column stays ascending."""
        out = {}
        for name in self._sk_widths:
            vals = cache[name]["sk_vals"][:, si]
            rows = cache[name]["sk_rows"][:, si].clone()
            if self.kv_quant == "int8":
                q, scale = quantize_int8_block(vals, axes=(2,),
                                                reciprocal=True)
                out[name] = {"vals": q, "scale": scale, "rows": rows}
            else:
                out[name] = {"vals": vals.clone(), "rows": rows}
        return out

    # -- trie ----------------------------------------------------------------
    def _push(self, node: _TrieNode) -> None:
        if node is self.root:
            return
        heapq.heappush(self._heap, (node.last_used, next(self._seq), node))
        # bound the lazy heap: under-budget traffic never drains it, so
        # compact it to one entry per live node once it outgrows a small
        # multiple of the node count
        if len(self._heap) > 4 * (len(self._nodes) + 16):
            fresh = {id(n): (lu, seq, n) for lu, seq, n in self._heap
                     if n.page_id >= 0 and lu == n.last_used}
            self._heap = sorted(fresh.values())

    def _touch(self, node: _TrieNode) -> None:
        self._clock += 1
        node.last_used = self._clock
        self._push(node)

    def lookup(self, prompt: np.ndarray) -> Tuple[int, _TrieNode]:
        """Longest restorable page-aligned cached prefix of ``prompt`` ->
        (length, node): the deepest matched node where a match may end
        (any page on global-attention-only stacks, else the deepest
        chunk-end node). Capped short of the prompt's end, so at least
        one suffix token prefills."""
        prompt = np.asarray(prompt)
        node, t, ps = self.root, 0, self.page_size
        best_t, best_node = 0, self.root
        while t + ps < len(prompt):
            child = node.children.get(
                tuple(int(x) for x in prompt[t:t + ps]))
            if child is None:
                break
            node = child
            t += ps
            self._touch(node)
            if node.snap_valid or self._page_terminals:
                best_t, best_node = t, node
        if self.l2 is not None:
            # the walk stalled: its demoted continuation, if any, is in
            # L2. Promote page by page until a miss, an integrity drop or
            # an unallocatable page ends the match (eviction only demotes
            # childless nodes, so a chain that left L1 never re-enters it)
            while t + ps < len(prompt):
                edge = tuple(int(x) for x in prompt[t:t + ps])
                child = self._promote(node, edge)
                if child is None:
                    break
                node = child
                t += ps
                if node.snap_valid or self._page_terminals:
                    best_t, best_node = t, node
        return best_t, best_node

    def ref(self, node: Optional[_TrieNode]) -> None:
        if node is not None and node is not self.root:
            node.refs += 1

    def unref(self, node: Optional[_TrieNode]) -> None:
        if node is not None and node is not self.root:
            node.refs -= 1
            if node.refs == 0:
                self._push(node)        # may have become evictable

    def _find_sk_donor(self, node: _TrieNode) -> Optional[_TrieNode]:
        """A leaf snapshot at or below ``node`` covers every boundary up
        to ``node.end`` with the same ring layout (only unwrapped prompts
        are captured): breadth-first, the first one found."""
        queue = collections.deque([node])
        while queue:
            n = queue.popleft()
            if n.sk_snap is not None:
                return n
            queue.extend(n.children.values())
        return None

    # -- eviction ------------------------------------------------------------
    def _alloc_page(self) -> Optional[int]:
        if self._free:
            return self._free.pop()
        while self._heap:
            lu, _, node = heapq.heappop(self._heap)
            if node.page_id < 0 or node.children or node.refs > 0 \
                    or lu != node.last_used:
                continue        # evicted / not a leaf / pinned / stale
            self._evict(node)
            return self._free.pop()
        return None

    def _evict(self, node: _TrieNode) -> None:
        if self.l2 is not None:
            self._demote(node)          # spill, don't lose
        node.parent.children.pop(node.tokens, None)
        self._nodes.discard(node)
        self._free.append(node.page_id)
        self._free.extend(node.sk_pages)    # the snapshot's budget charge
        node.sk_pages = []
        node.page_id = -1       # marks heap entries for this node stale
        node.snap = {}
        node.sk_snap = None
        if not node.parent.children:
            self._push(node.parent)     # the parent may now be evictable
        self.stats["pages_evicted"] += 1
        if self.tm is not None:
            self.tm.event("page_evict", track="cache",
                          demoted=self.l2 is not None, end=node.end)

    def spill(self, n: int) -> int:
        """Force-evict up to ``n`` LRU evictable nodes (the chaos
        ``spill`` site, or memory pressure from outside): demoted to L2
        when it is on, freed otherwise -> how many were evicted."""
        done = 0
        while done < n:
            victim = None
            while self._heap:
                lu, _, node = heapq.heappop(self._heap)
                if node.page_id < 0 or node.children or node.refs > 0 \
                        or lu != node.last_used:
                    continue
                victim = node
                break
            if victim is None:
                break
            self._evict(victim)
            done += 1
        return done

    # -- L2 tier (host-RAM page store) ----------------------------------------
    def _seg_kind(self, name: str) -> BlockKind:
        return self.segs[int(name[3:])].kind

    def _path_of(self, node: _TrieNode) -> Tuple[int, ...]:
        """Full token path from the root: the node's L2 blob key."""
        parts: List[Tuple[int, ...]] = []
        n = node
        while n is not self.root:
            parts.append(n.tokens)
            n = n.parent
        out: List[int] = []
        for tk in reversed(parts):
            out.extend(tk)
        return tuple(out)

    def _demote(self, node: _TrieNode) -> None:
        """Serialize an evicted node's durable payload (pool page rows
        and int8 scales, recurrent carry snapshot, A^3 sorted-key leaf
        snapshot) into one checksummed L2 blob. It runs only under
        eviction pressure, off the decode path: the one blocking read of
        the node from the card is counted and timed."""
        t0 = time.monotonic_ns()
        host = _host_tree({
            "page": {name: {leaf: t[:, node.page_id]
                            for leaf, t in seg.items()}
                     for name, seg in self.pool.items()},
            "snap": node.snap, "sk": node.sk_snap or {}})
        self.demote_reads += 1
        self.demote_read_ns += time.monotonic_ns() - t0
        snap = {name: MIXERS[self._seg_kind(name)].dump_snapshot(s)
                for name, s in host["snap"].items()}
        self.l2.put(self._path_of(node),
                    {"page": host["page"], "snap": snap, "sk": host["sk"],
                     "meta": {"snap_valid": np.uint8(node.snap_valid)}})
        if self.tm is not None:
            self.tm.event("l2_demote", track="cache", end=node.end)

    def _page_payload(self, tree: Dict[str, Any]) -> Dict[str, Any]:
        """A blob's pool page, each leaf checked against the pool's
        (ValueError on another shape or dtype)."""
        page = tree["page"]
        for name, seg in self.pool.items():
            for leaf, t in seg.items():
                h = page[name][leaf]
                want = (t.shape[0],) + tuple(t.shape[2:])
                if h.dtype != t.dtype or tuple(h.shape) != want:
                    raise ValueError(
                        f"L2 page {name}/{leaf}: {h.dtype} "
                        f"{tuple(h.shape)}, the pool holds {t.dtype} {want}")
        return page

    def _insert_page(self, pid: int, page: Dict[str, Any]) -> None:
        """The promotion's pool insert, in place: one staged page back
        into logical page ``pid`` of every pool leaf (K/V rows, int8
        scales)."""
        for name, seg in self.pool.items():
            for leaf, t in seg.items():
                t[:, pid] = page[name][leaf]

    def _promote(self, parent: _TrieNode, edge: Tuple[int, ...]
                 ) -> Optional[_TrieNode]:
        """Move one demoted page L2 -> L1: verify the blob, allocate a
        device page (which may itself demote an LRU victim), stage the
        host arrays through the pinned double buffer, insert them into
        the pool and re-create the trie node. None on a miss, or when a
        checksum mismatch or a malformed payload (``IntegrityError``,
        ``KeyError``, ``ValueError`` from the tree) drops this node, and
        only it, back to cold prefill (``stats["l2_integrity_drops"]``).
        A device or runtime error propagates."""
        ps = self.page_size
        key = self._path_of(parent) + edge
        if self.l2_fault_hook is not None and self.l2_fault_hook(key):
            self.l2.corrupt(key)        # chaos restore_corrupt site
        tree = self.l2.get(key)         # verified; None on a miss or rot
        if tree is None:
            return None
        # pin the attach point: the allocation's eviction must not demote
        # the very node being extended
        self.ref(parent)
        pid = None
        try:
            pid = self._alloc_page()
            if pid is None:
                return None     # the budget is all pinned; the blob stays
            snap_valid = _flag(tree["meta"]["snap_valid"])
            staged = self._stager.stage({
                "page": self._page_payload(tree) if self.pool else {},
                "snap": tree.get("snap", {}) if self._has_rec else {},
                "sk": tree.get("sk", {}) if self._sk_widths else {}})
            if self.pool:
                self._insert_page(pid, staged["page"])
            snap = {name: MIXERS[self._seg_kind(name)].load_snapshot(
                        h, self.device)
                    for name, h in staged["snap"].items()}
        except (IntegrityError, KeyError, ValueError):
            # a malformed payload: degrade this node only
            if pid is not None:
                self._free.append(pid)
            self.l2.discard(key)
            self.stats["l2_integrity_drops"] += 1
            if self.tm is not None:
                self.tm.event("l2_integrity_drop", track="cache",
                              tokens=len(key))
            return None
        finally:
            self.unref(parent)
        self.l2.pop(key)        # a page lives in exactly one tier
        child = _TrieNode(parent, edge, parent.end + ps)
        child.page_id = pid
        child.snap = snap
        child.snap_valid = snap_valid
        parent.children[edge] = child
        self._nodes.add(child)
        self._touch(child)
        if staged["sk"]:
            # re-charge the leaf snapshot's budget pages; dropping it is
            # not an error (the warm gather re-sorts the ring)
            self.ref(child)     # pin against the charge's own evictions
            charged: List[int] = []
            for _ in range(self._sk_cost):
                p = self._alloc_page()
                if p is None:
                    self._free.extend(charged)
                    charged = []
                    break
                charged.append(p)
            self.unref(child)
            if len(charged) == self._sk_cost:
                child.sk_pages = charged
                child.sk_snap = staged["sk"]
        if self.tm is not None:
            self.tm.event("l2_promote", track="cache", end=child.end)
        return child

    # -- admission -----------------------------------------------------------
    def admit(self, cache: Dict[str, Any], si: int, prompt: np.ndarray,
              fail_hook: Optional[Any] = None
              ) -> Tuple[Dict[str, Any], int, _TrieNode]:
        """Walk the trie and restore the matched prefix into slot ``si``
        of ``cache`` (in place) -> (cache, matched length, node). The
        caller may ``ref`` the node as the slot's recording anchor and
        ``unref`` it at prefill end. ``fail_hook(matched)``, when given,
        runs before a warm gather and may raise (a chaos gather failure):
        the cache is then untouched and no stats or refs are taken."""
        t, node = self.lookup(prompt)
        if t > 0:
            if fail_hook is not None:
                fail_hook(t)
            self.gather_into(cache, [(si, t, node)])
        return cache, t, node

    def gather_into(self, cache: Dict[str, Any],
                    entries: List[Tuple[int, int, _TrieNode]]
                    ) -> Dict[str, Any]:
        """Warm-admit every matched ``(si, t, node)`` in place, counted
        as one ``gather_dispatches`` however many slots it restores (the
        flash-crowd case). The entries must be pinned (``ref``) by the
        caller; page ids are resolved here."""
        ps = self.page_size
        packed = []
        for si, t, node in entries:
            # host block-table walk: the pool page of each page index
            chain: List[int] = []
            n = node
            while n is not self.root:
                chain.append(n.page_id)
                n = n.parent
            pid_of = np.asarray(chain[::-1], np.int64)
            by_width = {}
            for w in set(self._widths.values()):
                r = np.arange(w)
                q = (t - 1) - ((t - 1 - r) % w)   # position in ring row r
                qc = np.where(q >= 0, q, 0)
                a = self._upload(np.stack([pid_of[qc // ps], qc % ps,
                                           q >= 0]))
                by_width[w] = {"page": a[0], "off": a[1], "valid": a[2] > 0}
            sk_snaps: Dict[str, Any] = {}
            if self._sk_widths:
                donor = self._find_sk_donor(node)
                if donor is not None:
                    sk_snaps = donor.sk_snap
            packed.append({"si": si, "t": t,
                           "idx": {name: by_width[w]
                                   for name, w in self._widths.items()},
                           "snaps": node.snap if self._has_rec else {},
                           "sk": sk_snaps})
        gather_many_fn(self.segs, self.a3, cache, self.pool, packed)
        self.stats["prefix_hits"] += len(entries)
        self.stats["prefix_tokens_reused"] += sum(t for _, t, _ in entries)
        self.stats["gather_dispatches"] += 1
        if self.tm is not None:
            self.tm.event("prefix_hit", track="cache", hits=len(entries),
                          tokens=sum(t for _, t, _ in entries))
        return cache

    # -- recording -----------------------------------------------------------
    def record_boundary(self, cache: Dict[str, Any], si: int,
                        prompt: np.ndarray, boundary: int,
                        parent: _TrieNode, carry: bool = True
                        ) -> Optional[_TrieNode]:
        """Record the page of lane ``si`` ending at ``boundary`` (a page
        boundary the last prefill chunk crossed) under ``parent``: an
        existing child is shared (copy-on-write dedupe), else a page is
        allocated (evicting LRU if the budget is full) and copied
        pool-ward. ``carry`` marks the chunk's end, where the lane's
        state is the boundary state: only there is the recurrent carry
        snapshotted (an existing carry-less node is upgraded). Returns
        the child, or None when no page could be had."""
        ps = self.page_size
        key = tuple(int(x) for x in np.asarray(prompt)[boundary - ps:
                                                       boundary])
        child = parent.children.get(key)
        if child is not None:
            self._touch(child)
            if carry and not child.snap_valid:
                if self._has_rec:
                    child.snap = self._snapshot(cache, si)
                child.snap_valid = True
            if self.tm is not None:
                self.tm.event("page_dedupe", track="cache", end=child.end)
            return child
        page_id = self._alloc_page()
        if page_id is None:
            return None
        if self.pool:
            self._record_page(cache, si, page_id, boundary)
        child = _TrieNode(parent, key, boundary)
        child.page_id = page_id
        child.snap_valid = carry
        if carry and self._has_rec:
            child.snap = self._snapshot(cache, si)
        parent.children[key] = child
        self._nodes.add(child)
        self._touch(child)
        self.stats["pages_recorded"] += 1
        return child

    def record_final(self, cache: Dict[str, Any], si: int,
                     node: _TrieNode, prompt_len: int) -> None:
        """Leaf capture of lane ``si``'s A^3 sorted columns once a
        recorded prompt's final chunk folded the full-ring sort. Skipped
        when the prompt wrapped a sorted ring (a row would no longer be
        its position), when the node has one already, or when its
        ``sum(w) / page_size`` budget pages cannot be had (a warm
        admission without a donor re-sorts the gathered ring)."""
        if node is self.root or node.sk_snap is not None \
                or not self._sk_widths:
            return
        if any(prompt_len > w for w in self._sk_widths.values()):
            return
        charged: List[int] = []
        for _ in range(self._sk_cost):
            pid = self._alloc_page()
            if pid is None:
                self._free.extend(charged)
                return
            charged.append(pid)
        node.sk_pages = charged
        node.sk_snap = self._sk_snapshot(cache, si)

    # -- checkpoint ----------------------------------------------------------
    def dump_state(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """``(host meta, arrays)`` for the engine checkpoint: the trie in
        parent-before-child order, the pool and the nodes' snapshots (the
        carries through the mixers' ``dump_snapshot``). L2 blobs are not
        here: they are serialized bytes already (``l2.raw_items()``)."""
        nodes: List[_TrieNode] = []
        index = {id(self.root): -1}
        queue = collections.deque([self.root])
        while queue:
            n = queue.popleft()
            for child in n.children.values():
                index[id(child)] = len(nodes)
                nodes.append(child)
                queue.append(child)
        meta = {"nodes": [{"parent": index[id(n.parent)],
                           "tokens": list(n.tokens), "end": n.end,
                           "page_id": n.page_id,
                           "snap_valid": bool(n.snap_valid),
                           "sk_pages": list(n.sk_pages),
                           "last_used": n.last_used} for n in nodes],
                "free": list(self._free), "clock": self._clock}
        arrays = {
            "pool": self.pool,
            "snaps": {str(i): {name: MIXERS[self._seg_kind(name)]
                               .dump_snapshot(s)
                               for name, s in n.snap.items()}
                      for i, n in enumerate(nodes) if n.snap},
            "sks": {str(i): n.sk_snap for i, n in enumerate(nodes)
                    if n.sk_snap is not None}}
        return meta, arrays

    def load_state(self, meta: Dict[str, Any],
                   arrays: Dict[str, Any]) -> None:
        """Rebuild the trie and the pool of a freshly built cache from a
        checkpoint (host ``arrays`` copied onto the pool's device, each
        dtype bit for bit). Refcounts come back 0 (the engine re-pins its
        slots' recording anchors); the LRU clocks come back too, so the
        eviction order is the uninterrupted run's."""
        nodes: List[_TrieNode] = []
        for rec in meta["nodes"]:
            parent = (self.root if rec["parent"] < 0
                      else nodes[rec["parent"]])
            node = _TrieNode(parent, tuple(int(x) for x in rec["tokens"]),
                             int(rec["end"]))
            node.page_id = int(rec["page_id"])
            node.snap_valid = bool(rec["snap_valid"])
            node.sk_pages = [int(p) for p in rec["sk_pages"]]
            node.last_used = int(rec["last_used"])
            parent.children[node.tokens] = node
            self._nodes.add(node)
            nodes.append(node)
        for i, n in enumerate(nodes):
            snap = arrays.get("snaps", {}).get(str(i))
            if snap:
                n.snap = {name: MIXERS[self._seg_kind(name)].load_snapshot(
                              h, self.device) for name, h in snap.items()}
            sk = arrays.get("sks", {}).get(str(i))
            if sk is not None:
                n.sk_snap = {name: {k: v.to(self.device)
                                    for k, v in h.items()}
                             for name, h in sk.items()}
        if self.pool:
            copy_into(self.pool, arrays["pool"], "pool")
        self._free = [int(p) for p in meta["free"]]
        self._clock = int(meta["clock"])
        self._heap = []
        for n in nodes:
            self._push(n)

    # -- introspection -------------------------------------------------------
    @property
    def record_span(self) -> int:
        """Most tokens a recording chunk may advance: pages are read from
        the rings once at the chunk's end, so every crossed page must
        still be in the narrowest ring then (unbounded without
        attention)."""
        if not self._widths:
            return 1 << 30
        return max(self.page_size, min(self._widths.values()))

    @property
    def pages_in_use(self) -> int:
        return self.capacity - len(self._free)

    @property
    def referenced_nodes(self) -> int:
        """Trie nodes with a live refcount: pins exist only while a slot
        prefills, so between ticks with no prefilling slot this is 0."""
        return sum(1 for n in self._nodes if n.refs > 0)

    def __len__(self) -> int:
        return len(self._nodes)
