"""Weight prepacking — the software analogue of crossbar programming.

Weights are quantised and bit-sliced once, at load, instead of on every
forward call (the paper's program-once, reuse-many argument):

  * :class:`PackedLinear` — a linear weight in programmed form: int8
    differential planes ``[..., S, K, N]`` (what the ``bitslice_mvm``
    kernel reads), the recombined int8 weight ``[..., K, N]`` and the
    dequantisation scale.
  * :func:`pack_weight` — one float weight to a ``PackedLinear``.
  * :func:`prepack_params` — every ``{"w": ...}`` linear of a param tree
    but the MoE router, which runs in f32 in every mode.

Bit for bit the JAX package's ``core/prepack.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.config import PUMConfig
from repro_torch.core import bitslice


@dataclasses.dataclass(frozen=True)
class PackedLinear:
    """A linear weight in programmed (crossbar) form.

    planes — int8 ``[..., S, K, N]`` net differential planes; ``None``
             in int8 mode (the single plane *is* ``wq``).
    wq     — int8 ``[..., K, N]`` recombined quantised weight.
    scale  — f32 dequantisation scale: ``[..., 1, 1]`` per-tensor (pum)
             or ``[..., 1, N]`` per-out-channel (int8).
    """
    planes: torch.Tensor | None
    wq: torch.Tensor
    scale: torch.Tensor
    mode: str = "pum"
    weight_bits: int = 8
    bits_per_slice: int = 2

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.wq.shape)

    @property
    def ndim(self) -> int:
        return self.wq.ndim

    @property
    def device(self) -> torch.device:
        return self.wq.device


def pack_weight(w: torch.Tensor, cfg: PUMConfig) -> PackedLinear:
    """Quantise + bit-slice a float weight ``[..., K, N]`` once: a
    per-tensor scale (per element of any leading stack dims) for
    ``pum``, per-out-channel for ``int8``."""
    if cfg.mode not in ("int8", "pum"):
        raise ValueError(f"only int8/pum weights pack, got {cfg.mode!r}")
    if cfg.weight_bits > 8:
        raise ValueError(f"packed weights are stored int8; weight_bits="
                         f"{cfg.weight_bits} does not fit")
    w32 = w.to(torch.float32)
    if cfg.mode == "int8":
        q, s = bitslice.quantize_symmetric(w32, 8, axis=w.ndim - 2)
        return PackedLinear(None, q.to(torch.int8), s, "int8", 8, 1)
    q, s = bitslice.quantize_symmetric(w32, cfg.weight_bits,
                                       axis=(w.ndim - 2, w.ndim - 1))
    planes = bitslice.slice_planes_signed(q, cfg.weight_bits,
                                          cfg.bits_per_slice)
    planes = torch.movedim(planes, 0, -3).contiguous()    # [..., S, K, N]
    return PackedLinear(planes.to(torch.int8), q.to(torch.int8), s,
                        "pum", cfg.weight_bits, cfg.bits_per_slice)


def _packable(v: Any) -> bool:
    return (isinstance(v, torch.Tensor) and v.ndim >= 2
            and v.is_floating_point())


# linears that deliberately run outside the PUM path and must stay float:
# the MoE router executes in f32 whatever the mode (models/moe.py)
_SKIP_LINEARS = ("router",)


def prepack_params(params: Any, cfg: PUMConfig) -> Any:
    """Walk a param tree, packing every linear weight (``{"w": ...}``)
    but those of ``_SKIP_LINEARS``.  A no-op for ``mode="bf16"``;
    embeddings, expert stacks and other keys stay float."""
    if cfg.mode == "bf16":
        return params

    def walk(node, name=None):
        if isinstance(node, dict):
            skip = name in _SKIP_LINEARS
            return {k: (pack_weight(v, cfg)
                        if k == "w" and not skip and _packable(v)
                        else walk(v, k))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, name) for v in node)
        return node

    return walk(params)
