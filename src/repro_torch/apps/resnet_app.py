"""ResNet-20 application driver (paper §5.1 / §7.5), in PyTorch.

The JAX package's ``apps/resnet_app.py``.  No CIFAR-10 is available
offline, so the §7.5 noise/accuracy experiment is an *agreement* study:
the share of images on which the float model (``bf16`` mode, f32
``torch.matmul``) and the PUM model (``pum``: quantised, bit-sliced,
with programming noise in the ACE simulation when sigma > 0) predict
the same class, on synthetic class-conditional images, over a sweep of
noise levels.  Entry points run on the card unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import torch

from repro_torch.config import ADCConfig, NoiseConfig, PUMConfig
from repro_torch.device import resolve_device
from repro_torch.models import resnet

FLOAT = PUMConfig(mode="bf16")


def pum_config(prog_sigma: float) -> PUMConfig:
    """The reference's PUM config: 8-bit weights in 2-bit slices, a
    10-bit SAR ADC, programming noise enabled iff ``prog_sigma > 0``."""
    return PUMConfig(mode="pum", weight_bits=8, bits_per_slice=2,
                     noise=NoiseConfig(enable=prog_sigma > 0,
                                       prog_sigma=prog_sigma),
                     adc=ADCConfig("sar", bits=10))


def synthetic_images(generator: torch.Generator, n: int, classes: int = 10,
                     device: str | torch.device = "cuda",
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Class-conditional Gaussian blobs over 32x32x3: a prototype per
    class (N(0, 0.5^2) per pixel) plus N(0, 0.3^2) noise per image.
    Drawn on the generator's device, returned on ``device``."""
    dev = resolve_device(device)
    gd = generator.device
    labels = torch.randint(0, classes, (n,), generator=generator, device=gd)
    protos = torch.randn((classes, 32, 32, 3), generator=generator,
                         device=gd) * 0.5
    noise = torch.randn((n, 32, 32, 3), generator=generator, device=gd)
    return (protos[labels] + 0.3 * noise).to(dev), labels.to(dev)


@torch.no_grad()
def agreement(params: resnet.Params, x: torch.Tensor, prog_sigma: float,
              generator: torch.Generator | None = None) -> float:
    """Fraction of images on which the noisy-PUM model's class equals
    the float model's; ``generator`` draws the programming noise."""
    logits_f = resnet.resnet20_apply(params, x, FLOAT)
    logits_p = resnet.resnet20_apply(params, x, pum_config(prog_sigma),
                                     generator=generator)
    same = torch.argmax(logits_f, -1) == torch.argmax(logits_p, -1)
    return float(same.to(torch.float32).mean())


def agreement_under_noise(prog_sigma: float, n: int = 16, width: int = 8,
                          seed: int = 0,
                          device: str | torch.device = "cuda") -> float:
    """:func:`agreement` on a random-init ResNet-20 and ``n`` synthetic
    images, both drawn (then the noise) from one generator seeded with
    ``seed`` on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(seed)
    params = resnet.resnet20_init(gen, width=width, device=dev)
    x, _ = synthetic_images(gen, n, device=dev)
    return agreement(params, x, prog_sigma, gen)
