"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (GQA kv=16) d_ff=1024
vocab=50304, MoE 64e top-8.  [arXiv:2409.02060]"""
from repro_torch.config import MoEConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", family="moe", num_layers=16, d_model=2048,
        num_heads=16, num_kv_heads=16, d_ff=1024, vocab_size=50304,
        moe=MoEConfig(num_experts=64, top_k=8), moe_layer_period=1,
        rope_theta=10000.0, activation="silu", use_rmsnorm=True)


def reduced() -> ModelConfig:
    return config().replace(num_layers=2, d_model=64, num_heads=4,
                            num_kv_heads=4, d_ff=64, vocab_size=256,
                            moe=MoEConfig(num_experts=8, top_k=2))
