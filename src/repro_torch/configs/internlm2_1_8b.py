"""internlm2-1.8b [arXiv:2403.17297; hf].

Dense GQA decoder: 24L, d_model 2048, 16H kv=8, d_ff 8192, vocab 92544.
The same config as the JAX package's ``repro.configs.internlm2_1_8b``.
"""
from repro_torch.config import ModelConfig, register_arch


@register_arch("internlm2-1.8b")
def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-1.8b",
        family="dense",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=92544,
        head_dim=128,
        rope_theta=1_000_000.0,
    )
