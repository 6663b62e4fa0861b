"""command-r-plus-104b [dense]: 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000 — GQA, no-bias.  [hf:CohereForAI/c4ai-command-r]

Its packed weights (7.87 GB a layer in ``pum``) and the 12.6 GB f32
tied embedding do not fit one 80 GB card at 64 layers: the card serves
a cut of it at full width (``config().replace(num_layers=...)``).  Its
12 query heads a KV head split one position's heads over two CTAs of
the paged-attention kernel."""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b", family="dense", num_layers=64,
        d_model=12288, num_heads=96, num_kv_heads=8, d_ff=33792,
        vocab_size=256000, rope_theta=75000000.0, qkv_bias=False,
        activation="silu", use_rmsnorm=True, tie_embeddings=True)


def reduced() -> ModelConfig:
    return config().replace(num_layers=2, d_model=96, num_heads=6,
                            num_kv_heads=2, d_ff=192, vocab_size=512)
