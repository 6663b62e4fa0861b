"""Mamba-style selective SSM block (Jamba's sequence mixer), function
for function the JAX package's ``models/ssm.py``.

The four static projections (in, x, dt, out) route through PUMLinear,
so on the card through the MVM kernels; the recurrence's per-step
products stay plain PyTorch in f32, as the reference keeps them on the
standard compute path (XLA code there).

One token's update is the same code in every branch.  The causal conv
runs over the carried window followed by the new inputs (zeros for a
fresh state), its taps summed newest first and then ``+ b``; the state
update is :func:`_ssm_step`, ``h = h * da + db * x``, token by token.  A
decode step is the one-token case of a prefill into a state, so a
token fed alone gives the bits it gives inside a longer chunk, and the
scheduler's chunks give the solo loop's whole-prompt prefill.  The
contraction over the state lanes (``einsum("bis,bs->bi", h, c)`` in
the reference) is a fixed tree of elementwise adds
(``layers.lane_sum``): a row's value never depends on how many rows run
with it, which a batched GEMM kernel on the card would not promise.

Without a state (scoring a whole sequence) the reference runs a chunked
associative scan; the port runs the same recurrence sequentially from a
zero state (:func:`_scan_train`), which associates the products the
other way and so agrees within f32 rounding, not bit for bit.

The mixer returns its new state and leaves the given one alone; the
block writes it into the layer's state tensors in place
(``transformer.commit_state``), since captured graphs hold their
addresses.

``collect_states`` (the speculative verify step's): with a state, both
leaves gain a position axis, index t the state a t + 1-token run of
one-token steps would carry, bit for bit by construction: ``h`` after
token t from the same per-token loop, and the conv window rows t + 1 ..
t + W - 1 of the extended window, which is what the one-token steps
roll it to.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import layers

Params = dict[str, Any]

# the value each leaf of a fresh state holds
STATE_INIT = {"h": 0.0, "conv": 0.0}


def _inner(cfg: ModelConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def init_mamba(gen: torch.Generator, cfg: ModelConfig,
               device: torch.device | str = "cpu") -> Params:
    d = cfg.d_model
    inner = _inner(cfg)
    st = cfg.ssm_state_dim
    dt_rank = max(16, d // 16)
    f32 = dict(dtype=torch.float32, device=device)
    in_proj = layers.linear_init(gen, d, 2 * inner, device=device)
    conv_w = torch.randn((inner, cfg.ssm_conv_width), generator=gen,
                         **f32) * 0.2
    x_proj = layers.linear_init(gen, inner, dt_rank + 2 * st, device=device)
    dt_proj = layers.linear_init(gen, dt_rank, inner, bias=True,
                                 device=device)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((inner,), **f32),
        "x_proj": x_proj,
        "dt_proj": dt_proj,
        "a_log": torch.log(torch.arange(1, st + 1, **f32)).repeat(inner, 1),
        "d_skip": torch.ones((inner,), **f32),
        "out_proj": layers.linear_init(gen, inner, d, device=device),
    }


def make_ssm_state(cfg: ModelConfig, batch: int,
                   device: torch.device | str = "cpu") -> Params:
    inner = _inner(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros((batch, inner, cfg.ssm_state_dim), **f32),
            "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, inner),
                                **f32)}


def _causal_conv(ext: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """ext: [B, W-1+S, inner], the carried window then S inputs -> the
    depthwise causal conv of width W at the S inputs, [B, S, inner]:
    the reference's ``_causal_conv_train`` over the same extended
    window, taps newest first, then ``+ b``."""
    width = w.shape[-1]
    s = ext.shape[1] - (width - 1)
    out = ext[:, width - 1:] * w[:, -1]
    for i in range(1, width):
        out = out + ext[:, width - 1 - i:width - 1 - i + s] * w[:, -1 - i]
    return out + b


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, ``logaddexp(x, 0)`` = max(x, 0) +
    log1p(exp(-|x|)): no threshold, unlike ``F.softplus``."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _selective_params(p: Params, xc: torch.Tensor, cfg: ModelConfig):
    """xc: [B, S, inner] post-conv activations -> (dt, B_t, C_t, A)."""
    st = cfg.ssm_state_dim
    dt_rank = p["dt_proj"]["w"].shape[0]
    proj = layers.linear(p["x_proj"], xc, cfg.pum)
    dt_raw = proj[..., :dt_rank]
    b_t = proj[..., dt_rank:dt_rank + st]
    c_t = proj[..., dt_rank + st:]
    dt = _softplus(layers.linear(p["dt_proj"], dt_raw, cfg.pum))
    a = -torch.exp(p["a_log"].to(torch.float32))          # [inner, st]
    return dt, b_t, c_t, a


def _ssm_step(h, xt, dtt, btt, ctt, a, d_skip):
    """One token of the recurrence, f32: h [B, inner, st]; xt, dtt
    [B, inner]; btt, ctt [B, st] -> (h', y [B, inner])."""
    da = torch.exp(dtt[:, :, None] * a)
    db = dtt[:, :, None] * btt[:, None, :]
    h = h * da + db * xt[:, :, None]
    y = layers.lane_sum(h * ctt[:, None, :]) + d_skip * xt
    return h, y


def _recurrence(h, xc, dt, b_t, c_t, a, d_skip, collect: bool = False):
    """:func:`_ssm_step` over the S tokens of [B, S, ...] inputs from
    ``h``: (the last h, or with ``collect`` every token's [B, S, inner,
    st]; y [B, S, inner])."""
    ys, hs = [], []
    for t in range(xc.shape[1]):
        h, y = _ssm_step(h, xc[:, t], dt[:, t], b_t[:, t], c_t[:, t], a,
                         d_skip)
        ys.append(y)
        if collect:
            hs.append(h)
    if collect:
        h = torch.stack(hs, dim=1)
    return h, torch.stack(ys, dim=1)


def mamba(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
          state: Params | None = None, collect_states: bool = False,
          ) -> tuple[torch.Tensor, Params | None]:
    """x: [B, S, D] -> (y [B, S, D], new state or None).

    The reference's three branches: no state (a whole sequence from zero,
    :func:`_scan_train`); a prefill into a state (S > 1, the conv over
    the carried window, then the recurrence token by token); and the
    one-token decode, which is that prefill at S = 1, so the two agree
    bit for bit by construction.  The conv window is f32, and the new
    inputs are cast into it, so the conv, dt, h and y are f32; y is
    rounded to the activation dtype before the output gate.
    ``collect_states`` (needs ``state``): the state after every token,
    ``h`` [B, S, inner, st] and ``conv`` [B, S, W-1, inner]."""
    b = x.shape[0]
    inner = _inner(cfg)
    win = cfg.ssm_conv_width - 1
    xz = layers.linear(p["in_proj"], x, cfg.pum)
    xi, z = xz[..., :inner], xz[..., inner:]
    if state is None:
        window = torch.zeros((b, win, inner), dtype=torch.float32,
                             device=x.device)
    else:
        window = state["conv"].to(torch.float32)
    ext = torch.cat([window, xi.to(torch.float32)], dim=1)
    xc = F.silu(_causal_conv(ext, p["conv_w"], p["conv_b"]))
    dt, b_t, c_t, a = _selective_params(p, xc, cfg)
    if state is None:
        y = _scan_train(xc, dt, b_t, c_t, a, p["d_skip"])
        new_state = None
    else:
        h, y = _recurrence(state["h"].to(torch.float32), xc, dt, b_t, c_t,
                           a, p["d_skip"], collect=collect_states)
        if collect_states:
            conv = torch.stack([ext[:, t + 1:t + 1 + win]
                                for t in range(x.shape[1])], dim=1)
        else:
            conv = ext[:, ext.shape[1] - win:]
        new_state = {"h": h, "conv": conv}
    y = y.to(x.dtype) * F.silu(z)
    return layers.linear(p["out_proj"], y, cfg.pum), new_state


def _scan_train(xc, dt, b_t, c_t, a, d_skip) -> torch.Tensor:
    """The linear recurrence h_t = da_t * h_{t-1} + db_t * x_t over a
    whole sequence from a zero state: xc/dt [B, S, inner], b_t/c_t
    [B, S, st], a [inner, st] -> y [B, S, inner].  Sequential, where the
    reference runs an associative scan in chunks of 256 tokens (the same
    products, associated otherwise)."""
    bsz, _, inner = xc.shape
    h0 = torch.zeros((bsz, inner, b_t.shape[-1]), dtype=torch.float32,
                     device=xc.device)
    return _recurrence(h0, xc, dt, b_t, c_t, a, d_skip)[1]
