"""deepseek-moe-16b [arXiv:2401.06066; hf].

Fine-grained MoE: 64 routed experts (top-6) + 2 shared experts, expert
width 1408; the first layer is a dense FFN (paper SS3.2). 16 heads with
16 KV heads (MHA), 28L, d_model 2048, vocab 102400.
The same config as the JAX package's ``repro.configs.deepseek_moe_16b``.
"""
from repro_torch.config import ModelConfig, MoEConfig, register_arch


@register_arch("deepseek-moe-16b")
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        family="moe",
        num_layers=28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=10944,                      # dense layer-0 FFN width
        vocab_size=102400,
        head_dim=128,
        rope_theta=10000.0,
        moe=MoEConfig(num_experts=64, num_shared=2, top_k=6,
                      d_expert=1408, num_dense_layers=1),
    )
