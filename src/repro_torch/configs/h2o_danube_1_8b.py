"""h2o-danube-1.8b [arXiv:2401.16818; hf].

Llama/Mistral-style dense decoder with sliding-window attention
(window 4096), 24L, d_model 2560, 32 heads (GQA kv=8, head_dim 80),
vocab 32000. The window bounds the KV ring to 4096 rows.
The same config as the JAX package's ``repro.configs.h2o_danube_1_8b``.
"""
from repro_torch.config import AttentionKind, ModelConfig, register_arch


@register_arch("h2o-danube-1.8b")
def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b",
        family="dense",
        num_layers=24,
        d_model=2560,
        num_heads=32,
        num_kv_heads=8,
        d_ff=6912,
        vocab_size=32000,
        head_dim=80,
        rope_theta=10000.0,
        attention_kind=AttentionKind.SLIDING,
        window_size=4096,
    )
