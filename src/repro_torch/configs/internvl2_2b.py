"""internvl2-2b [arXiv:2404.16821; hf].

InternViT-300M (a stub frontend, :mod:`repro_torch.models.frontend`:
precomputed patch embeddings) + the InternLM2-1.8B language backbone:
24L, d_model 2048, 16H kv=8, d_ff 8192, vocab 92553 (padded to 92672,
the next multiple of 128; see ``decoder.padded_vocab``). The same config
as the JAX package's ``repro.configs.internvl2_2b``.
"""
from repro_torch.config import ModelConfig, register_arch


@register_arch("internvl2-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b",
        family="vlm",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=92553,
        head_dim=128,
        rope_theta=1_000_000.0,
        frontend="vision_patches",
    )
