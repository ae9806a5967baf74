"""recurrentgemma-2b [arXiv:2402.19427 (Griffin); hf].

Hybrid: repeating (RG-LRU, RG-LRU, local attention) pattern, window
2048, GQA kv=1 (MQA), head_dim 256, d_model 2560, vocab 256000, GELU
FFN, tied embeddings. RG-LRU blocks have no softmax over keys, so A^3
applies only to the attention third (and there only to global windows).
The same config as the JAX package's ``repro.configs.recurrentgemma_2b``.
"""
from repro_torch.config import AttentionKind, BlockKind, ModelConfig, \
    register_arch


@register_arch("recurrentgemma-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        num_layers=26,
        d_model=2560,
        num_heads=10,
        num_kv_heads=1,
        d_ff=7680,
        vocab_size=256000,
        head_dim=256,
        rope_theta=10000.0,
        attention_kind=AttentionKind.SLIDING,
        window_size=2048,
        block_pattern=(BlockKind.RGLRU, BlockKind.RGLRU,
                       BlockKind.ATTENTION),
        tie_embeddings=True,
        act="gelu",
    )
