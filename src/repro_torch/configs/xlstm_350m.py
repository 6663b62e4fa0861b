"""xlstm-350m [ssm]: 24L d_model=1024 4H d_ff=0 vocab=50304 — sLSTM +
mLSTM blocks (one sLSTM per 4 blocks; the published 350M config mixes
both kinds).  [arXiv:2405.04517]

Recurrent state, no KV cache.  d_ff=0: the mLSTM/sLSTM blocks carry
their own 2x up/down projections."""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m", family="ssm", num_layers=24, d_model=1024,
        num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=50304,
        xlstm_slstm_every=4, activation="gelu", use_rmsnorm=False)


def reduced() -> ModelConfig:
    return config().replace(num_layers=4, d_model=64, num_heads=2,
                            num_kv_heads=2, vocab_size=256,
                            xlstm_slstm_every=2)
