"""llava-next-mistral-7b [vlm]: 32L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=32000 — anyres tiling; the vision frontend is a STUB
(the caller provides precomputed patch embeddings: 5 anyres tiles x 576
patches = 2880 image tokens).  [hf:llava-hf/llava-v1.6-mistral-7b-hf]

``lm.forward(image_embeds=)`` projects them through ``vision_proj`` and
puts them in front of the prompt's token embeddings; the scheduler and
the CLI serve text alone, as the reference's do."""
from repro_torch.config import ModelConfig

NUM_IMAGE_TOKENS = 2880       # anyres: 4 tiles + base, 24x24 patches each


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b", family="vlm", num_layers=32,
        d_model=4096, num_heads=32, num_kv_heads=8, d_ff=14336,
        vocab_size=32000, vision_stub=True,
        num_image_tokens=NUM_IMAGE_TOKENS,
        rope_theta=1000000.0, activation="silu", use_rmsnorm=True)


def reduced() -> ModelConfig:
    return config().replace(num_layers=2, d_model=64, num_heads=4,
                            num_kv_heads=2, d_ff=128, vocab_size=256,
                            num_image_tokens=8)
