"""PyTorch/CUDA port of the DARTH-PUM serving stack.

Mirrors the JAX package module for module (``core``, ``kernels``,
``models``, ``serve``, ``launch``); the JAX package is the reference
its tests hold it against.  Entry points run on the card unless the
caller passes ``device="cpu"``; the hand-written Hopper kernels live
under ``kernels/*/csrc`` and are built on first use.
"""
