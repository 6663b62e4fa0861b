"""ResNet-20 (CIFAR-10) on the PUM execution model (paper §5.1).

The JAX package's ``models/resnet.py`` function for function.
Convolutions use the Toeplitz/im2col expansion the paper describes:
each conv becomes an MVM [N*H'*W', Cin*k*k] x [Cin*k*k, Cout] executed
by :func:`~repro_torch.core.pum_linear.pum_linear` (the ACE path; in
``pum`` mode the ``bitslice_mvm`` kernel on the card).  Batch-norm,
ReLU and pooling stay on the digital path as plain tensor ops.

Plain functions on tensors in NHWC, as the reference: params are nested
dicts of tensors; ``resnet20_init`` draws them from a
``torch.Generator`` with the JAX package's distributions (the law is
the same, the numbers differ; the parity tests carry JAX's weights
across with ``repro_torch.bridge.resnet_params_from_numpy``).
``generator`` of the apply functions draws the analog noise of a ``pum``
config with ``noise.enable``, one layer after another.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.config import PUMConfig
from repro_torch.core.pum_linear import pum_linear
from repro_torch.device import resolve_device

Params = dict[str, Any]


def _he_init(gen: torch.Generator, shape: tuple[int, ...], fan_in: int,
             device: torch.device) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * math.sqrt(2.0 / fan_in)).to(device)


def im2col(x: torch.Tensor, k: int = 3, stride: int = 1) -> torch.Tensor:
    """NHWC -> [N, H', W', C*k*k] patches (SAME padding): patch order
    (di, dj) outer, channels inner; a stride subsamples the full-size
    patches, as the reference does."""
    _, h, w, _ = x.shape
    pad = k // 2
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    cols = torch.cat([xp[:, di:di + h, dj:dj + w, :]
                      for di in range(k) for dj in range(k)], dim=-1)
    if stride > 1:
        cols = cols[:, ::stride, ::stride, :]
    return cols


def conv_init(gen: torch.Generator, cin: int, cout: int, k: int = 3,
              device: torch.device | str = "cpu") -> Params:
    fan_in = cin * k * k
    return {"w": _he_init(gen, (fan_in, cout), fan_in, torch.device(device))}


def conv_apply(p: Params, x: torch.Tensor, pum: PUMConfig, k: int = 3,
               stride: int = 1,
               generator: torch.Generator | None = None) -> torch.Tensor:
    cols = im2col(x, k, stride)                     # [N,H',W',cin*k*k]
    return pum_linear(cols, p["w"], pum, generator=generator)


def bn_init(c: int, device: torch.device | str = "cpu") -> Params:
    return {"scale": torch.ones((c,), device=device),
            "bias": torch.zeros((c,), device=device),
            "mean": torch.zeros((c,), device=device),
            "var": torch.ones((c,), device=device)}


def bn_apply(p: Params, x: torch.Tensor, train: bool) -> torch.Tensor:
    """Eval statistics, or (``train``) the batch's, over N, H and W."""
    if train:
        mean = torch.mean(x, dim=(0, 1, 2))
        var = torch.var(x, dim=(0, 1, 2), unbiased=False)
    else:
        mean, var = p["mean"], p["var"]
    inv = p["scale"] * torch.rsqrt(var + 1e-5)
    return (x - mean) * inv + p["bias"]


def block_init(gen: torch.Generator, cin: int, cout: int,
               device: torch.device | str = "cpu") -> Params:
    p = {"conv1": conv_init(gen, cin, cout, device=device),
         "bn1": bn_init(cout, device),
         "conv2": conv_init(gen, cout, cout, device=device),
         "bn2": bn_init(cout, device)}
    if cin != cout:
        p["proj"] = {"w": _he_init(gen, (cin, cout), cin,
                                   torch.device(device))}
    return p


def block_apply(p: Params, x: torch.Tensor, pum: PUMConfig, stride: int,
                train: bool,
                generator: torch.Generator | None = None) -> torch.Tensor:
    h = conv_apply(p["conv1"], x, pum, stride=stride, generator=generator)
    h = torch.relu(bn_apply(p["bn1"], h, train))
    h = conv_apply(p["conv2"], h, pum, generator=generator)
    h = bn_apply(p["bn2"], h, train)
    sc = x
    if stride > 1:
        sc = sc[:, ::stride, ::stride, :]
    if "proj" in p:
        sc = pum_linear(sc, p["proj"]["w"], pum, generator=generator)
    return torch.relu(h + sc)


def resnet20_init(generator: torch.Generator, num_classes: int = 10,
                  width: int = 16, device: str | torch.device = "cuda",
                  ) -> Params:
    """He-normal weights from ``generator`` (drawn on its device, then
    moved to ``device``), eval batch-norm statistics, a zero fc bias."""
    dev = resolve_device(device)
    p: Params = {"stem": conv_init(generator, 3, width, device=dev),
                 "bn0": bn_init(width, dev)}
    widths = [width, 2 * width, 4 * width]
    for s, wd in enumerate(widths):
        cin = width if s == 0 else widths[s - 1]
        for b in range(3):
            p[f"s{s}b{b}"] = block_init(generator, cin if b == 0 else wd, wd,
                                        dev)
    p["fc"] = {"w": _he_init(generator, (4 * width, num_classes), 4 * width,
                             dev),
               "b": torch.zeros((num_classes,), device=dev)}
    return p


def resnet20_apply(p: Params, x: torch.Tensor, pum: PUMConfig,
                   train: bool = False,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """x: [N, 32, 32, 3] -> logits [N, num_classes]."""
    h = conv_apply(p["stem"], x, pum, generator=generator)
    h = torch.relu(bn_apply(p["bn0"], h, train))
    for s in range(3):
        for b in range(3):
            stride = 2 if (s > 0 and b == 0) else 1
            h = block_apply(p[f"s{s}b{b}"], h, pum, stride, train,
                            generator)
    h = torch.mean(h, dim=(1, 2))                   # global avg pool (DCE)
    return pum_linear(h, p["fc"]["w"], pum, bias=p["fc"]["b"],
                      generator=generator)
