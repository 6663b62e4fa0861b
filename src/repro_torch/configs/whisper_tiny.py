"""whisper-tiny [audio]: 4L d_model=384 6H d_ff=1536 vocab=51865 —
enc-dec, conv frontend (STUB: the caller provides precomputed 1500-frame
embeddings).  [arXiv:2212.04356]

``ServeEngine.generate(encoder_frames=)`` runs the encoder over the
frames and the decoder with cross-attention over its output; the
scheduler and the CLI run the decoder alone, as the reference's do.
As in the reference, the decoder takes no RoPE and no positional
embedding of its own."""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny", family="audio", num_layers=4, d_model=384,
        num_heads=6, num_kv_heads=6, d_ff=1536, vocab_size=51865,
        is_encoder_decoder=True, encoder_layers=4, encoder_seq=1500,
        activation="gelu", use_rmsnorm=False, tie_embeddings=True)


def reduced() -> ModelConfig:
    return config().replace(num_layers=2, encoder_layers=2, d_model=64,
                            num_heads=4, num_kv_heads=4, d_ff=128,
                            vocab_size=256, encoder_seq=32)
