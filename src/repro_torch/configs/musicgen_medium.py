"""musicgen-medium [arXiv:2306.05284; hf].

Decoder-only transformer over EnCodec tokens: 48L, d_model 1536, 24
heads (MHA, kv=24, head_dim 64), d_ff 6144, vocab 2048 (one codebook).
The EnCodec frontend is a stub (:mod:`repro_torch.models.frontend`): the
backbone takes precomputed frame embeddings. The same config as the JAX
package's ``repro.configs.musicgen_medium``.
"""
from repro_torch.config import ModelConfig, register_arch


@register_arch("musicgen-medium")
def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        family="audio",
        num_layers=48,
        d_model=1536,
        num_heads=24,
        num_kv_heads=24,
        d_ff=6144,
        vocab_size=2048,
        head_dim=64,
        rope_theta=10000.0,
        frontend="audio_frames",
        num_codebooks=4,
        act="gelu",
    )
