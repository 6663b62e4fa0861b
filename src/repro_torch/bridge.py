"""The weight bridge: the JAX package's param tree -> the port's params
(and its gradient and optimiser-state trees, which have the params'
structure).

The input is the JAX tree with every array already converted to numpy
(the caller does that, so this module never sees a JAX array):

  * nested dicts / lists of ``np.ndarray``;
  * a packed linear as a dict ``{"planes", "wq", "scale", "mode",
    "weight_bits", "bits_per_slice"}`` (``planes`` None in int8 mode) —
    the arrays and the static quant metadata of a JAX ``PackedLinear``;
  * ``params["blocks"]``: a list of ``period`` group-stacked trees whose
    leaves carry a leading ``[n_groups]`` axis.

The port keeps one param dict per layer, so the bridge unstacks the
groups: layer ``g * period + j`` is group ``g`` of ``blocks[j]``.  That
is the layout of any period: an xLSTM stack's (period 2 in the reduced
configs, 4 at full width, 5 where ``num_layers=10`` makes it ragged)
comes across with its mixer params, bias leaves and packed ``[d, 4]``
gates as a dense one's, an MoE layer with its ``[G, E, D, F]``
expert stacks and its f32 router (never packed) as ``[E, D, F]`` and
``[D, E]`` tensors, and a Mamba layer of Jamba's period 8 with its conv
taps ``[inner, W]``, conv bias, ``a_log``, ``d_skip`` and ``dt_proj``'s
bias as float tensors beside its four packed projections.  An
encoder-decoder's ``encoder["blocks"]``, one tree stacked over
``[encoder_layers]``, is unstacked the same way, a dict a layer; a
decoder block's ``norm_x`` and ``cross`` and a vision stub's
``vision_proj`` come across as any other node.  Packed planes keep the
JAX ``[S, K, N]`` layout.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core.prepack import PackedLinear
from repro_torch.device import resolve_device

_PACKED_KEYS = {"planes", "wq", "scale", "mode", "weight_bits",
                "bits_per_slice"}


def _is_packed(node: Any) -> bool:
    return isinstance(node, dict) and set(node) == _PACKED_KEYS


def _tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def _convert(node: Any, dev: torch.device, index: int | None) -> Any:
    """Arrays to tensors, taking ``[index]`` of each leaf when given."""
    def leaf(a):
        if a is None:
            return None
        a = np.asarray(a)
        return _tensor(a if index is None else a[index], dev)

    if _is_packed(node):
        return PackedLinear(leaf(node["planes"]), leaf(node["wq"]),
                            leaf(node["scale"]), str(node["mode"]),
                            int(node["weight_bits"]),
                            int(node["bits_per_slice"]))
    if isinstance(node, dict):
        return {k: _convert(v, dev, index) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_convert(v, dev, index) for v in node)
    return leaf(node)


def _n_groups(node: Any) -> int:
    if _is_packed(node):
        return int(np.asarray(node["wq"]).shape[0])
    if isinstance(node, dict):
        return _n_groups(next(iter(node.values())))
    if isinstance(node, (list, tuple)):
        return _n_groups(node[0])
    return int(np.asarray(node).shape[0])


def params_from_numpy(tree: dict[str, Any], cfg: ModelConfig,
                      device: str | torch.device = "cuda") -> dict[str, Any]:
    """The port's per-layer params from a numpy copy of the JAX tree."""
    dev = resolve_device(device)
    period = len(tree["blocks"])
    groups = _n_groups(tree["blocks"][0])
    if period * groups != cfg.num_layers:
        raise ValueError(f"{period} x {groups} stacked blocks do not make "
                         f"{cfg.num_layers} layers")
    out = {k: _convert(v, dev, None) for k, v in tree.items()
           if k not in ("blocks", "encoder")}
    out["blocks"] = [_convert(tree["blocks"][j], dev, g)
                     for g in range(groups) for j in range(period)]
    if "encoder" in tree:
        enc = tree["encoder"]
        if _n_groups(enc["blocks"]) != cfg.encoder_layers:
            raise ValueError(f"{_n_groups(enc['blocks'])} stacked encoder "
                             f"blocks, not {cfg.encoder_layers}")
        out["encoder"] = {k: _convert(v, dev, None) for k, v in enc.items()
                          if k != "blocks"}
        out["encoder"]["blocks"] = [_convert(enc["blocks"], dev, layer)
                                    for layer in range(cfg.encoder_layers)]
    return out


def opt_state_from_numpy(tree: dict[str, Any], cfg: ModelConfig,
                         device: str | torch.device = "cuda"
                         ) -> dict[str, Any]:
    """The port's optimiser state (``train.step.init_opt_state``) from a
    numpy copy of the JAX package's: ``m``, ``v`` and an error-feedback
    residual ``ef`` have the params' structure and are unstacked as
    they are, ``count`` becomes an int32 scalar tensor.  A gradient tree
    crosses with :func:`params_from_numpy` itself."""
    dev = resolve_device(device)
    out = {k: params_from_numpy(v, cfg, dev) for k, v in tree.items()
           if k != "count"}
    out["count"] = _tensor(np.asarray(tree["count"], np.int32), dev)
    return out


def tree_from_numpy(tree: dict[str, Any],
                    device: str | torch.device = "cuda") -> dict[str, Any]:
    """The port's params from a numpy copy of a JAX param tree that has
    no stacked blocks: the same nested dicts and lists, tensors for
    arrays, a ``PackedLinear`` for each packed-linear dict.  The ResNet's
    (``models/resnet.py``) and the encoder app's (``apps/encoder_app.py``:
    ``embed``, ``pos`` and a ``layers`` list of bare matrices)."""
    return _convert(tree, resolve_device(device), None)


resnet_params_from_numpy = encoder_params_from_numpy = tree_from_numpy
