"""grok-1-314b [hf:xai-org/grok-1; unverified].

8 experts top-2, 64L, d_model 6144, 48 heads (GQA kv=8), expert FFN
32768, vocab 131072, logit softcap 30. About 314 B parameters: more
than one card holds, so the port runs it only as its smoke variant.
The same config as the JAX package's ``repro.configs.grok_1_314b``.
"""
from repro_torch.config import ModelConfig, MoEConfig, register_arch


@register_arch("grok-1-314b")
def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b",
        family="moe",
        num_layers=64,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=32768,
        vocab_size=131072,
        head_dim=128,
        rope_theta=10000.0,
        logit_softcap=30.0,
        moe=MoEConfig(num_experts=8, num_shared=0, top_k=2,
                      d_expert=32768, num_dense_layers=0),
    )
