"""Shared helpers of the port's parity tests (``test_torch_*.py``):
carry JAX values across to the port as numpy arrays."""
from __future__ import annotations

import numpy as np

from repro.core.prepack import PackedLinear


def to_numpy(tree):
    """A JAX param tree with numpy leaves; a ``PackedLinear`` becomes
    the dict ``repro_torch.bridge`` takes."""
    if isinstance(tree, PackedLinear):
        return {"planes": None if tree.planes is None
                else np.asarray(tree.planes),
                "wq": np.asarray(tree.wq), "scale": np.asarray(tree.scale),
                "mode": tree.mode, "weight_bits": tree.weight_bits,
                "bits_per_slice": tree.bits_per_slice}
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return np.asarray(tree)
