"""Atomic, keep-K checkpoints in the JAX package's layout
(``ckpt/checkpoint.py``):

    <dir>/step_<N:08d>/
        manifest.json        {"step", "leaves": {path: {"file", "shape",
                                                        "dtype"}}}
        <leaf-path>.npy      one file per leaf

  * **atomicity**: written to ``step_N.tmp``, then renamed; a crash
    mid-save never corrupts the previous checkpoint;
  * **keep-K** retention with cleanup;
  * **resume**: the manifest carries the step counter, and the data
    stream is a function of (seed, step), so a restart repeats it.

Leaf paths are dotted, dict keys sorted and list items by index, as the
reference's.  The paths are the port's own: its blocks are a list with
one entry a layer (``params.blocks.3.attn.wq.w``) where the reference
stacks each period position's layers into one array.  Loading puts the
tensors on the caller's device.  The reference's elastic restore under
a mesh's shardings has no counterpart on one card.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree.keys()):
            out.update(_flatten(tree[k], f"{prefix}.{k}" if prefix else k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}.{i}"))
    else:
        out[prefix] = tree
    return out


def _unflatten_into(template: Any, flat: dict[str, Any], prefix: str = ""):
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}.{k}" if prefix else k)
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten_into(v, flat, f"{prefix}.{i}")
                              for i, v in enumerate(template))
    return flat[prefix]


def _steps(directory: str) -> list[int]:
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    """Atomic save.  Returns the final checkpoint path."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}}
    for path, leaf in _flatten(tree).items():
        arr = leaf.detach().cpu().numpy()
        fname = path.replace("/", "_") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][path] = {"file": fname,
                                    "shape": list(arr.shape),
                                    "dtype": str(arr.dtype)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


def load_checkpoint(directory: str, template: Any, step: int | None = None,
                    device: str | torch.device = "cuda") -> tuple[Any, int]:
    """Restore into ``template``'s structure, the tensors on ``device``;
    the latest step unless ``step`` is given."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {leaf_path: torch.from_numpy(
                np.load(os.path.join(path, meta["file"]))).to(dev)
            for leaf_path, meta in manifest["leaves"].items()}
    return _unflatten_into(template, flat), manifest["step"]


class CheckpointManager:
    """Keep-K rolling checkpoints and resume."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree: Any) -> str:
        path = save_checkpoint(self.directory, step, tree)
        self._cleanup()
        return path

    def restore(self, template: Any, device: str | torch.device = "cuda",
                ) -> tuple[Any, int] | None:
        if latest_step(self.directory) is None:
            return None
        return load_checkpoint(self.directory, template, device=device)

    def _cleanup(self):
        for s in _steps(self.directory)[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def all_steps(self) -> list[int]:
        return _steps(self.directory)
