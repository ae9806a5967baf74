"""The per-rank plan of a sharded dispatch: what one rank of a mesh holds
and computes in a training step or a serving dispatch. One builder for
both (``train.step`` and the serving dispatches of ``models.decoder``):

* the model axis (``ShardingConfig.tp_axis``): a module whose weights the
  rules cut over it keeps this rank's share and computes only that share
  (``models.common.ActShardings``): attention its q heads (training and
  whole-prompt prefill, where the axis divides them; else its block of
  the q rows with the whole weights) or its columns of every projection
  (chunked prefill and decode); the dense FFN its ``d_ff`` columns; the
  MoE its experts or its slice of each; the LM head its vocab rows; the
  RG-LRU its channels, the mLSTM its heads (:meth:`MeshPlan.mlstm_groups`:
  where the axis does not divide them but their count divides it, a
  group of ranks shares each head, each rank holding its block of the
  head's value columns) and the sLSTM its channels. The sLSTM's ``wx``
  and ``b`` stay whole: the layout cuts them by gate, and a rank needs
  its channels of every gate;
* the batch: training rows as ``train.step`` passes them; serving lanes,
  this rank's block of B over (pod, data) (``batch_spec``). ``rows`` is
  the ranks whose rows make up the batch: the MoE gathers its routing
  integers over them (one device's capacity and drops) and splits its
  capacity slots over them;
* the KV rings (``cache_specs``): their rows over ``model``, or over
  (data, model) when the batch is smaller than the data axis;
* every parameter is a DTensor laid out by ``param_specs``; each layer's
  weights are gathered just in time over every mesh dim but the model
  axis where the layer keeps its share (:meth:`MeshPlan.layer_context`),
  and dropped after use.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Sequence, Tuple

import torch

from repro_torch.config import BlockKind, ModelConfig, ShapeConfig, \
    ShapeKind, ShardingConfig
from repro_torch.launch.mesh import block_ring
from repro_torch.models.common import NEG_INF, ActShardings, PoolShare, \
    Ring, activation_shardings
from repro_torch.sharding.rules import act_specs, batch_spec, mesh_sizes

DISPATCHES = ("train", "prefill", "chunk", "decode")
# the weights whose FSDP block of d_model a small-batch decode keeps
# (models.common.klinear): the dense attention and FFN, embed, LM head
_KDIM_LEAVES = tuple(f".{m}.{w}.weight" for m, ws in (
    ("attn", ("wq", "wk", "wv", "wo")),
    ("ffn", ("w_gate", "w_up", "w_down"))) for w in ws) + (
    "embed", "lm_head.weight")


def dims_of(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (None, a name or a tuple)."""
    return () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))


def group_name(mesh, axes: Sequence[str]) -> str:
    """The process group over ``axes`` of ``mesh`` (flattened, major axis
    first, when there are several)."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0]).group_name
    return mesh[axes]._flatten().get_group().group_name


class MeshPlan:
    """One rank's plan of ``dispatch`` (one of :data:`DISPATCHES`) for
    ``cfg`` at ``shape`` on ``mesh``. ``row_dims`` are the training step's
    batch plan (the mesh dims over which the rows differ and gradients are
    summed); ``select_shards`` the serving A^3 selection blocks (0: none,
    A^3 off). ``rows`` / ``rows_dim``: the :class:`Ring` of ranks whose
    rows make up the batch, each holding a block of the batch (0) or of
    the sequence (1); None where no mesh dim splits the rows."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, mesh,
                 sharding_cfg: ShardingConfig, *, dispatch: str,
                 row_dims: Tuple[str, ...] = (),
                 select_shards: int = 0):
        if dispatch not in DISPATCHES:
            raise ValueError(f"dispatch {dispatch!r} not in {DISPATCHES}")
        sh = sharding_cfg
        self.cfg, self.shape, self.mesh, self.dispatch = cfg, shape, mesh, \
            dispatch
        self.sharding_cfg, self.pool = sh, None
        self.names = tuple(mesh.mesh_dim_names)
        self.sizes = mesh_sizes(mesh)
        self.coord = dict(zip(self.names, mesh.get_coordinate()))
        self.row_dims = tuple(row_dims)
        self.rows, self.rows_dim = self._ring(self.row_dims), 0
        self.select_shards = select_shards
        tp = sh.tp_axis if (sh.tensor_parallel
                            and self.sizes.get(sh.tp_axis, 1) > 1) else None
        self.tp = tp
        self.tp_dim = self.names.index(tp) if tp else None
        self.model = self.sizes[tp] if tp else 1
        self.specs = act_specs(cfg, shape, mesh, sh)
        self.heads_split = tp is not None and \
            self.specs.get("q", (None,) * 4)[1] == tp
        self.model_group = mesh.get_group(tp).group_name if tp else None
        # the ranks that share this rank's mLSTM heads (mlstm_groups)
        self.cols = None
        groups = self.mlstm_groups()
        if groups is not None and groups[1] > 1 and any(
                cfg.block_kind(i) == BlockKind.MLSTM
                for i in range(cfg.num_layers)):
            self.cols = block_ring(mesh, tp, groups[1])

        # serving lanes: this rank's block of the batch over (pod, data)
        self.lanes = None
        self.lane_group, self.lane_size = None, 1
        b = shape.global_batch
        batch_dims = dims_of(batch_spec(shape, mesh, sh)[0])
        if dispatch != "train" and batch_dims:
            self.rows = self._ring(batch_dims)
            n, idx = self.rows.size, self.rows.index
            self.lanes = (idx * (b // n), (idx + 1) * (b // n))
            self.lane_size = n
            if n > 1:
                axes = [a for a in batch_dims if self.sizes[a] > 1]
                self.lane_group = group_name(mesh, axes)
        # the KV rings: over the model axis, or (data, model) when the
        # batch is smaller than the data axis (cache_specs)
        self.ring = self.sp = self.kdim = None
        if dispatch != "train":
            dp = math.prod(self.sizes[a] for a in sh.dp_axes
                           if a in self.sizes)
            batch_ok = b % dp == 0 and b >= dp
            axes = (sh.tp_axis,) if batch_ok else (sh.fsdp_axis, sh.tp_axis)
            self.ring = self._ring([a for a in axes if a in self.sizes])
            # a batch smaller than the data axis: a prefill splits the
            # sequence over the ring's ranks, a decode its dense products'
            # contraction over the data axis (act_specs)
            if not batch_ok:
                fsdp = sh.fsdp_axis
                if dispatch == "prefill" and self.ring is not None and \
                        shape.seq_len % self.ring.size == 0:
                    self.sp = self.ring
                    self.rows, self.rows_dim = self.sp, 1
                elif dispatch == "decode" and self.sizes.get(fsdp, 1) > 1:
                    self.kdim = Ring(group_name(mesh, (fsdp,)),
                                     self.sizes[fsdp], self.coord[fsdp])
                    self.k_dim = self.names.index(fsdp)
            if self.ring is not None and select_shards % self.ring.size:
                raise ValueError(
                    f"select_shards {select_shards} is not a multiple of "
                    f"the {self.ring.size} ranks the KV ring is split over")
        self._layer_plans: Dict[int, Tuple[str, ActShardings]] = {}

    def _ring(self, axes: Sequence[str]):
        """The :class:`Ring` over mesh dims ``axes`` (major first; this
        rank's index its block's), None for no dims."""
        if not axes:
            return None
        idx = 0
        for a in axes:
            idx = idx * self.sizes[a] + self.coord[a]
        return Ring(group_name(self.mesh, axes),
                    math.prod(self.sizes[a] for a in axes), idx)

    # -- what a rank computes -------------------------------------------
    def splits(self, kind: BlockKind) -> bool:
        """Whether a recurrent block of ``kind`` computes this rank's
        channels (heads) of the model axis."""
        if self.tp is None:
            return False
        cfg = self.cfg
        if kind == BlockKind.RGLRU:
            return (cfg.num_heads * cfg.resolved_head_dim) % self.model == 0
        if kind == BlockKind.MLSTM:
            return self.mlstm_groups() is not None
        if kind == BlockKind.SLSTM:
            return cfg.d_model % self.model == 0
        return False

    def mlstm_groups(self):
        """(g, r): the mLSTM's H heads over g = gcd(H, M) groups of the M
        model-axis ranks, each head's value columns over the r = M / g
        ranks of its group; None where the mLSTM stays whole on every
        rank. The layout gives each rank a contiguous block of H hd / M of
        the head-major rows of ``wq`` / ``wk`` / ``wv`` / ``w_o`` (and
        columns of ``w_out``): H / M whole heads where M divides H (r = 1),
        one head's hd / r columns where H divides M. Where neither divides
        the other, that block is not one rank's heads and columns, and the
        mLSTM stays whole."""
        if self.tp is None:
            return None
        h, m = self.cfg.num_heads, self.model
        if h % m and (m % h or self.cfg.resolved_head_dim % (m // h)):
            return None
        g = math.gcd(h, m)
        return g, m // g

    def keeps(self, name: str, p) -> bool:
        """Whether parameter ``name`` stays cut over the model axis: its
        layout cuts it there and its module computes a share."""
        if self.sp is not None and name not in ("embed", "lm_head.weight"):
            return False          # a block of the rows: whole weights
        if self.tp is None or not hasattr(p, "placements") or \
                not p.placements[self.tp_dim].is_shard():
            return False
        if name.endswith((".slstm.wx.weight", ".slstm.b")):
            return False
        for mod, kind in ((".rnn.", BlockKind.RGLRU),
                          (".mlstm.", BlockKind.MLSTM),
                          (".slstm.", BlockKind.SLSTM)):
            if mod in name:
                return self.splits(kind)
        if ".attn." in name:
            return self.heads_split or self.dispatch in ("chunk", "decode")
        return True

    def gather(self, name: str, p):
        """The tensor this rank computes with: ``p`` gathered over every
        mesh dim, but the model axis where it keeps its share. Its
        gradient is summed over the ranks of other rows and cut to
        ``p``'s layout in the backward."""
        if not hasattr(p, "placements"):
            return p
        from torch.distributed.tensor import Partial, Replicate
        keep = self.keeps(name, p)
        kkeep = self.kdim is not None and name.endswith(_KDIM_LEAVES)
        pl = tuple(p.placements[k] if ((k == self.tp_dim and keep) or
                                       (kkeep and k == self.k_dim))
                   else Replicate() for k in range(len(self.names)))
        grad_pl = tuple(Partial() if n in self.row_dims else pl[k]
                        for k, n in enumerate(self.names))
        return p.redistribute(self.mesh, pl).to_local(
            grad_placements=grad_pl)

    def plan(self, split=(), layer_hook=None) -> ActShardings:
        return ActShardings(
            self.specs, self.rows, rows_dim=self.rows_dim,
            axis=self.tp or "model", size=self.model,
            index=self.coord[self.tp] if self.tp else 0,
            group=self.model_group, split=split, lanes=self.lanes,
            lane_group=self.lane_group, lane_size=self.lane_size,
            ring=self.ring, select_shards=self.select_shards,
            max_len=self.shape.seq_len, sp=self.sp, kdim=self.kdim,
            pool=self.pool, layer_hook=layer_hook, cols=self.cols)

    def layer_plan(self, blk, prefix: str) -> ActShardings:
        """The plan of layer ``blk`` (parameter names from ``prefix``):
        its modules that hold a parameter keeping its share."""
        return self.plan([m for n, m in blk.named_modules()
                          if any(self.keeps(f"{prefix}{n}.{k}" if n
                                            else prefix + k, p)
                                 for k, p in m.named_parameters())])

    def register(self, model) -> None:
        for si, seg in enumerate(model.segs):
            for li, blk in enumerate(seg.layers):
                if id(blk) not in self._layer_plans:
                    pre = f"segs.{si}.layers.{li}."
                    self._layer_plans[id(blk)] = (pre,
                                                  self.layer_plan(blk, pre))

    @contextlib.contextmanager
    def layer_context(self, blk):
        """Layer ``blk`` with its weights gathered and its plan on."""
        from torch.nn.utils.stateless import _reparametrize_module
        prefix, act = self._layer_plans[id(blk)]
        full = {n: self.gather(prefix + n, p)
                for n, p in blk.named_parameters()}
        with _reparametrize_module(blk, full), activation_shardings(act):
            yield

    @contextlib.contextmanager
    def model_context(self, model, layer_hook=None):
        """``model``'s top-level weights (embed, final norm, LM head)
        gathered and the top plan on; ``layer_hook`` goes to the plan."""
        from torch.nn.utils.stateless import _reparametrize_module
        self.register(model)
        params = dict(model.named_parameters())
        top = {n: self.gather(n, p) for n, p in params.items()
               if not n.startswith("segs.")}
        act = self.plan([model] if self.keeps("embed", params["embed"])
                        else [], layer_hook)
        with _reparametrize_module(model, top), activation_shardings(act):
            yield

    def dispatch_context(self, model):
        """The context a serving dispatch of ``model`` runs in: each layer
        of the decoder's loops enters :meth:`layer_context`."""
        return self.model_context(model, self.layer_context)

    # -- the serving state ----------------------------------------------
    def _cut_leaf(self, seg, name: str, t: torch.Tensor) -> torch.Tensor:
        if self.lanes is not None and t.dim() >= 2:
            t = t[:, self.lanes[0]:self.lanes[1]]
        if seg.kind == BlockKind.ATTENTION:
            if t.dim() == 5:
                ring = self.ring if (self.ring is not None and
                                     t.shape[3] % self.ring.size == 0) \
                    else None
                if ring is not None:
                    lo, hi = ring.span(t.shape[3])
                    t = t[:, :, :, lo:hi]
            return t
        if not self.splits(seg.kind):
            return t
        i = self.coord[self.tp]
        if seg.kind == BlockKind.MLSTM:
            # C [L, B, H, Dk, Dv] over heads and value columns; n
            # [L, B, H, Dk] and m [L, B, H] over heads only (the same on
            # the ranks that share a head)
            g, r = self.mlstm_groups()
            a, c = divmod(i, r)
            n = t.shape[2] // g
            t = t.narrow(2, a * n, n)
            if t.dim() == 5:
                n = t.shape[4] // r
                t = t.narrow(4, c * n, n)
            return t
        n = t.shape[-1] // self.model
        return t.narrow(t.dim() - 1, i * n, n)

    def cut_cache(self, cache: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's share of a whole serving cache (a copy): its lanes,
        its ring rows and its recurrent channels."""
        from repro_torch.models.mixer import build_segments
        segs = build_segments(self.cfg)
        return {f"seg{i}": {k: self._cut_leaf(seg, k, v).clone()
                            for k, v in cache[f"seg{i}"].items()}
                for i, seg in enumerate(segs)}

    def init_cache(self, batch: int, max_len: int, dtype=None,
                   a3: bool = False, device="cuda") -> Dict[str, Any]:
        """This rank's share of ``decoder.init_cache(cfg, batch, max_len)``
        (under a ``FakeTensorMode`` when the caller is in one)."""
        from repro_torch.models import decoder
        from repro_torch.models.mixer import build_segments
        whole = decoder.init_cache(self.cfg, batch, max_len, dtype, a3,
                                   device="meta")
        segs = build_segments(self.cfg)
        out = {}
        for i, seg in enumerate(segs):
            leaves = {}
            for k, v in whole[f"seg{i}"].items():
                shp = self._cut_leaf(seg, k, v).shape
                fill = NEG_INF if (k == "m" and seg.kind in (
                    BlockKind.MLSTM, BlockKind.SLSTM)) else 0
                leaves[k] = torch.full(shp, fill, dtype=v.dtype,
                                       device=device)
            out[f"seg{i}"] = leaves
        return out

    # -- the prefix cache's page pool ----------------------------------
    def pool_share(self, pages: int, page_size: int) -> PoolShare:
        """This rank's share of a page pool [L, pages, Hkv, page_size, D],
        laid out as ``cache_specs`` lays a ring with the pages in the
        batch's place: pages over (pod, data) where they divide, page
        rows over ``model`` (or (data, model) when the pages do not
        divide over the data axes)."""
        import torch.distributed as dist
        from repro_torch.sharding.rules import cache_specs
        spec = cache_specs(torch.empty((1, pages, 1, page_size, 1),
                                       device="meta"),
                           ShapeConfig("pool", ShapeKind.DECODE, page_size,
                                       pages), self.mesh, self.sharding_cfg)

        def block(entry, n):
            axes = dims_of(entry)
            size = math.prod(self.sizes[a] for a in axes)
            idx = 0
            for a in axes:
                idx = idx * self.sizes[a] + self.coord[a]
            return idx * (n // size), (idx + 1) * (n // size)

        return PoolShare(dist.group.WORLD.group_name,
                         *block(spec[1], pages), *block(spec[3], page_size))

    def with_pool(self, pages: int, page_size: int) -> "MeshPlan":
        """This plan with its layers' plans carrying the pool's share
        (``gather_fn`` on a mesh)."""
        self.pool = self.pool_share(pages, page_size)
        self._layer_plans.clear()
        return self

    def cut_pool(self, pool: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's share of a whole page pool (a copy)."""
        out = {}
        for name, leaves in pool.items():
            sh = self.pool_share(leaves["k"].shape[1], leaves["k"].shape[3])
            cut = {}
            for k, v in leaves.items():
                v = v[:, sh.p0:sh.p1]
                if k in ("k", "v"):           # the scales have no rows
                    v = v[:, :, :, sh.r0:sh.r1]
                cut[k] = v.clone()
            out[name] = cut
        return out

    def init_pool(self, pages: int, page_size: int, dtype=None,
                  a3: bool = False, kv_quant: str = "none",
                  device="cuda") -> Dict[str, Any]:
        """This rank's share of ``decoder.init_page_pool``."""
        from repro_torch.models import decoder
        whole = decoder.init_page_pool(self.cfg, pages, page_size, dtype, a3,
                                       kv_quant, device="meta")
        return {name: {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
                       for k, v in leaves.items()}
                for name, leaves in self.cut_pool(whole).items()}


def serving_plan(cfg: ModelConfig, mesh, sharding_cfg: ShardingConfig, *,
                 batch: int, max_len: int, dispatch: str,
                 select_shards: int = 0) -> MeshPlan:
    """The :class:`MeshPlan` of a serving dispatch over ``batch`` lanes
    of rings sized for ``max_len``."""
    kind = ShapeKind.DECODE if dispatch == "decode" else ShapeKind.PREFILL
    return MeshPlan(cfg, ShapeConfig(dispatch, kind, max_len, batch), mesh,
                    sharding_cfg, dispatch=dispatch,
                    select_shards=select_shards)
