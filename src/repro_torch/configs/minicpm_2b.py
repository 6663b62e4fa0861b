"""minicpm-2b [dense]: 40L d_model=2304 36H (GQA kv=36) d_ff=5760
vocab=122753 — WSD schedule (arch=llama-like).  [arXiv:2404.06395]

Multi-head attention (one query a KV head) at head dim 64, tied
embeddings and an odd vocabulary (padded to 122 880 columns).  The WSD
learning-rate schedule is a training feature, which the port does not
have yet."""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b", family="dense", num_layers=40, d_model=2304,
        num_heads=36, num_kv_heads=36, d_ff=5760, vocab_size=122753,
        rope_theta=10000.0, activation="silu", use_rmsnorm=True,
        tie_embeddings=True)


def reduced() -> ModelConfig:
    return config().replace(num_layers=2, d_model=72, num_heads=6,
                            num_kv_heads=6, d_ff=144, vocab_size=256)
