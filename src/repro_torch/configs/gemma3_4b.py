"""gemma3-4b [hf:google/gemma-3-*-pt; unverified].

5:1 local:global attention pattern (window 1024 local layers, full
global layers), 128k context, GQA kv=4, head_dim 256, 262k vocab, tied
embeddings, GELU FFN. A^3 runs on the global layers only: the local
layers already bound the search window.
The same config as the JAX package's ``repro.configs.gemma3_4b``.
"""
from repro_torch.config import AttentionKind, ModelConfig, register_arch


@register_arch("gemma3-4b")
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b",
        family="dense",
        num_layers=34,
        d_model=2560,
        num_heads=8,
        num_kv_heads=4,
        d_ff=10240,
        vocab_size=262144,
        head_dim=256,
        max_seq_len=131072,
        rope_theta=1_000_000.0,
        attention_kind=AttentionKind.LOCAL_GLOBAL,
        local_global_pattern=5,
        window_size=1024,
        tie_embeddings=True,
        act="gelu",
    )
