"""xlstm-350m [arXiv:2405.04517; unverified].

xLSTM[7:1]: 7 mLSTM blocks per sLSTM block, 24L, d_model 1024, 4 heads,
no separate FFN (d_ff=0: the blocks carry their own projections), vocab
50304, tied embeddings. Neither block type has a softmax score vector
over n keys, so A^3 does not apply: the arch runs without the technique.
The same config as the JAX package's ``repro.configs.xlstm_350m``.
"""
from repro_torch.config import BlockKind, ModelConfig, register_arch

_PATTERN = (BlockKind.MLSTM,) * 7 + (BlockKind.SLSTM,)


@register_arch("xlstm-350m")
def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m",
        family="ssm",
        num_layers=24,
        d_model=1024,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        head_dim=256,
        block_pattern=_PATTERN,
        tie_embeddings=True,
    )
