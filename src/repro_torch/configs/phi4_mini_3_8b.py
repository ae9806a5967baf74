"""phi4-mini-3.8b [arXiv:2412.08905; hf].

Dense decoder: RoPE, SwiGLU, GQA kv=8, 32L, d_model 3072, 200k vocab.
The same config as the JAX package's ``repro.configs.phi4_mini_3_8b``.
"""
from repro_torch.config import ModelConfig, register_arch


@register_arch("phi4-mini-3.8b")
def config() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-3.8b",
        family="dense",
        num_layers=32,
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=200064,
        head_dim=128,
        rope_theta=10000.0,
    )
