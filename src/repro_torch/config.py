"""Configuration for the PyTorch port: the subset of ``repro.config``
that the serving path reads, kept as an independent copy so that the
port imports nothing from the JAX package.

Plain dataclasses (stdlib only) and a registry of named architectures.
Field names, defaults and derived values (``A3Config.m_for``,
``threshold_nats``, ``param_count``, ``smoke_variant``) match the
reference exactly, so a config built here describes the same model as
its JAX namesake.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple


class AttentionKind(str, enum.Enum):
    FULL = "full"                  # global causal attention
    SLIDING = "sliding"            # sliding-window attention
    LOCAL_GLOBAL = "local_global"  # pattern of local + global layers


class BlockKind(str, enum.Enum):
    ATTENTION = "attention"
    RGLRU = "rglru"
    MLSTM = "mlstm"
    SLSTM = "slstm"


class A3Mode(str, enum.Enum):
    OFF = "off"                     # exact attention
    CONSERVATIVE = "conservative"   # paper: M = n/2, T = 5%
    AGGRESSIVE = "aggressive"       # paper: M = n/8, T = 10%
    CUSTOM = "custom"


@dataclass(frozen=True)
class A3Config:
    """The paper's approximation scheme (fields as in the reference)."""
    mode: A3Mode = A3Mode.OFF
    m_fraction: float = 0.5
    m_absolute: Optional[int] = None
    threshold_pct: float = 5.0
    int_bits: Optional[int] = None
    frac_bits: Optional[int] = None
    lut_exponent: bool = False
    block_q: int = 128
    block_k: int = 128
    # the KV ring is split into this many contiguous blocks for the
    # compact decode walk (1 = single-shard, paper-literal selection)
    select_shards: int = 1

    def m_for(self, n: int) -> int:
        if self.m_absolute is not None:
            return min(self.m_absolute, n)
        return max(1, int(round(self.m_fraction * n)))

    @property
    def threshold_nats(self) -> float:
        return -math.log(self.threshold_pct / 100.0)

    @staticmethod
    def conservative() -> "A3Config":
        return A3Config(mode=A3Mode.CONSERVATIVE, m_fraction=0.5,
                        threshold_pct=5.0)

    @staticmethod
    def aggressive() -> "A3Config":
        return A3Config(mode=A3Mode.AGGRESSIVE, m_fraction=0.125,
                        threshold_pct=10.0)


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int            # routed experts
    num_shared: int = 0         # always-on shared experts (deepseek-moe)
    top_k: int = 2
    d_expert: int = 0           # per-expert FFN hidden dim (0 -> d_ff)
    router_jitter: float = 0.0
    load_balance_coef: float = 0.01
    # the first k layers keep a dense FFN (deepseek-moe: 1)
    num_dense_layers: int = 0


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    max_seq_len: int = 131072
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    attention_kind: AttentionKind = AttentionKind.FULL
    window_size: int = 4096
    local_global_pattern: int = 0
    block_pattern: Tuple[BlockKind, ...] = ()
    moe: Optional[MoEConfig] = None
    frontend: Optional[str] = None
    num_codebooks: int = 1
    act: str = "swiglu"
    logit_softcap: float = 0.0
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def block_kind(self, layer_idx: int) -> BlockKind:
        if not self.block_pattern:
            return BlockKind.ATTENTION
        return self.block_pattern[layer_idx % len(self.block_pattern)]

    def layer_is_global(self, layer_idx: int) -> bool:
        if self.attention_kind != AttentionKind.LOCAL_GLOBAL:
            return self.attention_kind == AttentionKind.FULL
        p = self.local_global_pattern
        return (layer_idx % (p + 1)) == p

    def param_count(self) -> int:
        """Analytic parameter count (the reference's formula)."""
        d, h = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.num_heads, self.num_kv_heads
        attn = d * (n_q * h) + 2 * d * (n_kv * h) + (n_q * h) * d
        if self.act == "swiglu":
            ffn_dense = 3 * self.d_model * self.d_ff
        else:
            ffn_dense = 2 * self.d_model * self.d_ff
        total = 0
        for i in range(self.num_layers):
            kind = self.block_kind(i)
            if kind == BlockKind.ATTENTION:
                total += attn
            elif kind == BlockKind.RGLRU:
                d_rnn = n_q * h
                total += 2 * d * d_rnn + 4 * d_rnn
            elif kind == BlockKind.MLSTM:
                total += d * (n_q * h) * 3 + (n_q * h) * d + 2 * d * 2 * d
            elif kind == BlockKind.SLSTM:
                total += 4 * d * d + 4 * d * d
            if kind in (BlockKind.MLSTM, BlockKind.SLSTM) and self.d_ff == 0:
                pass  # xlstm has no separate FFN
            elif self.moe is not None and i >= self.moe.num_dense_layers:
                de = self.moe.d_expert or self.d_ff
                n_exp = self.moe.num_experts + self.moe.num_shared
                total += 3 * self.d_model * de * n_exp \
                    + d * self.moe.num_experts
            else:
                total += ffn_dense
            total += 2 * d  # norms
        total += self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * d
        return total


SHED_POLICIES = ("reject-new", "evict-oldest-queued")


@dataclass(frozen=True)
class ServeConfig:
    """The engine knobs this port implements (names, defaults and checks
    as in the reference's ``ServeConfig``)."""
    slots: int = 4
    max_len: int = 2048
    # admission-prefill chunk; None = min(max_len, 512)
    prefill_chunk: Optional[int] = None
    # adaptive chunking: ticks with >= 1 decoding slot shrink the chunk
    # to this floor (None = fixed chunk)
    prefill_chunk_min: Optional[int] = None
    # decode steps past the sorted_upto watermark before an A^3 re-sort
    resort_every: int = 64
    # decode steps per decode dispatch
    decode_block: int = 1
    # decode-block harvests left in flight behind the tick loop
    # (0 = synchronous harvest)
    pipeline_depth: int = 0
    # 0 = greedy argmax; > 0 draws from the tempered softmax, keyed per
    # (sample_seed, request uid, position)
    temperature: float = 0.0
    sample_seed: int = 0
    # bounded admission: most QUEUED requests (0 = unbounded) and which
    # request a full queue sheds
    max_queue: int = 0
    shed_policy: str = "reject-new"
    # default per-request deadline in engine ticks (None = none)
    deadline_ticks: Optional[int] = None
    # most terminal entries kept in the status/result maps, results
    # popped on first read (0 = unbounded)
    retain_results: int = 0

    def __post_init__(self):
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {self.slots}")
        if self.max_len < 1:
            raise ValueError(f"max_len must be >= 1, got {self.max_len}")
        if self.prefill_chunk is not None and self.prefill_chunk <= 0:
            raise ValueError(
                f"prefill_chunk must be positive, got "
                f"{self.prefill_chunk} (use None for the default chunk)")
        if self.prefill_chunk_min is not None:
            if self.prefill_chunk_min <= 0:
                raise ValueError(
                    f"prefill_chunk_min must be positive, got "
                    f"{self.prefill_chunk_min} (use None to disable the "
                    f"adaptive policy)")
            if self.prefill_chunk is not None \
                    and self.prefill_chunk_min > self.prefill_chunk:
                raise ValueError(
                    f"prefill_chunk_min ({self.prefill_chunk_min}) must "
                    f"not exceed prefill_chunk ({self.prefill_chunk})")
        if self.decode_block < 1:
            raise ValueError(
                f"decode_block must be >= 1, got {self.decode_block}")
        if self.pipeline_depth < 0:
            raise ValueError(
                f"pipeline_depth must be >= 0, got {self.pipeline_depth} "
                f"(0 = synchronous harvest)")
        if self.temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}")
        if self.max_queue < 0:
            raise ValueError(
                f"max_queue must be >= 0, got {self.max_queue} "
                f"(0 = unbounded queue)")
        if self.shed_policy not in SHED_POLICIES:
            raise ValueError(
                f"shed_policy must be 'reject-new' or "
                f"'evict-oldest-queued', got {self.shed_policy!r}")
        if self.deadline_ticks is not None and self.deadline_ticks < 1:
            raise ValueError(
                f"deadline_ticks must be >= 1, got "
                f"{self.deadline_ticks} (use None for no deadline)")
        if self.retain_results < 0:
            raise ValueError(
                f"retain_results must be >= 0, got "
                f"{self.retain_results} (0 = unbounded retention)")


_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register_arch(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_arch(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (populates the registry)
    if name not in _REGISTRY:
        raise KeyError(f"arch {name!r} is not yet ported to repro_torch; "
                       f"have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> List[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (as the
    reference's ``smoke_variant``)."""
    kw: Dict[str, Any] = dict(
        num_layers=min(cfg.num_layers, 2 if not cfg.block_pattern
                       else len(cfg.block_pattern)),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2)
        if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        max_seq_len=512,
        window_size=64,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=min(cfg.moe.top_k, 2),
            d_expert=64 if cfg.moe.d_expert else 0,
            num_dense_layers=min(cfg.moe.num_dense_layers, 1))
    return dataclasses.replace(cfg, **kw)
