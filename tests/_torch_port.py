"""Shared helpers of the port's parity tests (``test_torch_*.py``):
carry JAX values across to the port as numpy arrays, and compare the
port's serving tokens with JAX's under the margin rule."""
from __future__ import annotations

import jax
import jax.numpy as jnp
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


def jax_logits_along(eng, prompt, tokens):
    """JAX's last-position logits [len(tokens), V] before each of
    ``tokens``, fed one by one through its solo prefill and decode."""
    states, lg, _ = eng.prefill(jnp.asarray([prompt], jnp.int32))
    steps = [np.asarray(lg)[0, -1]]
    for i, tok in enumerate(tokens[:-1]):
        with eng.mesh_ctx():
            lg, states = eng._decode(eng.params, states,
                                     jnp.asarray([[tok]], jnp.int32),
                                     jnp.int32(len(prompt) + i))
        steps.append(np.asarray(lg)[0, -1])
    return np.stack(steps)


def margin(row):
    top2 = np.sort(row)[-2:]
    return float(top2[1] - top2[0])


def scores_at(logits, temperature, seed, row=0, batch=1):
    """JAX's per-step scores at ``temperature``: the logits at t <= 0,
    else the Gumbel noise of the step's key plus ``logits / t``; the key
    is ``PRNGKey(seed)`` for the first token, folded with ``i`` before
    token ``i + 1`` (``generate_loop``'s chain, the slot step's too).
    A batch of ``batch`` rows drawn with one key (``generate``) takes
    its noise over [batch, V]: row ``row`` of it."""
    if temperature <= 0:
        return logits
    key, rows = jax.random.PRNGKey(seed), []
    for i, step in enumerate(logits):
        if i:
            key = jax.random.fold_in(key, i - 1)
        noise = np.asarray(jax.random.gumbel(key, (batch,) + step.shape))
        rows.append(noise[row] + step / np.float32(temperature))
    return np.stack(rows)


def agree_outside_near_ties(got, want, scores, tol, temperature):
    """``got`` equals ``want`` up to their first difference, which must
    fall on a step whose JAX score margin is within 10x ``tol`` (over
    ``t`` when sampling): past it the two legitimately diverge.  Returns
    the steps that agree."""
    bound = 10 * tol / (temperature if temperature > 0 else 1.0)
    for i, w in enumerate(want):
        if got[i] != w:
            assert margin(scores[i]) <= bound, (i, got, want)
            return i
    return len(want)
