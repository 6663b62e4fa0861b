"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2 — Mamba+attn 1:7 interleave, MoE every other
layer.  [arXiv:2403.19887]

Only the attention layers (one in 8, at position 4 of each period) keep
a KV cache; the Mamba layers carry O(1) state a slot.  The full depth
holds 16 MoE layers of f32 expert stacks (11.27 GB each), more than one
80 GB card holds; the card runs one 8-layer period
(``config().replace(num_layers=8)``), which keeps the whole layout."""
from repro_torch.config import MoEConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid", num_layers=32, d_model=4096,
        num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=65536,
        attn_period=8,                     # 1 attention per 8 layers (1:7)
        moe=MoEConfig(num_experts=16, top_k=2), moe_layer_period=2,
        ssm_state_dim=16, ssm_conv_width=4, ssm_expand=2,
        rope_theta=10000.0, activation="silu", use_rmsnorm=True)


def reduced() -> ModelConfig:
    return config().replace(num_layers=8, d_model=64, num_heads=4,
                            num_kv_heads=2, d_ff=128, vocab_size=256,
                            moe=MoEConfig(num_experts=4, top_k=2),
                            ssm_state_dim=8)
