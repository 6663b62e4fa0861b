"""glm4-9b [dense]: 40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552 — RoPE, GQA.  [hf:THUDM/glm-4-9b]

Its 16 query heads a KV head split one position's heads over two CTAs
of the paged-attention kernel (8 queries a CTA); its lm head is its
own (untied)."""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b", family="dense", num_layers=40, d_model=4096,
        num_heads=32, num_kv_heads=2, d_ff=13696, vocab_size=151552,
        rope_theta=10000.0, activation="silu", use_rmsnorm=True)


def reduced() -> ModelConfig:
    return config().replace(num_layers=2, d_model=64, num_heads=4,
                            num_kv_heads=2, d_ff=128, vocab_size=256)
