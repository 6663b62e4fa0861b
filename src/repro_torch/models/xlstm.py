"""xLSTM blocks (Beck et al., 2024): mLSTM (matrix memory) and sLSTM
(scalar memory with exponential gating), function for function the JAX
package's ``models/xlstm.py``.

mLSTM has a parallel (attention-like) form, run when there is no state
(scoring a whole sequence), and a recurrent form for serving: a prompt
is fed into the state one token at a time, and a decode step is the
same recurrence at one token.  sLSTM is recurrent only.  The
projections route through PUMLinear; the recurrences are plain PyTorch
(the reference's are XLA code), in f32 as the reference's: gate
pre-activations and states in f32, ``k / sqrt(hd)`` and the output gate
in the activation dtype.

The mixers return their new state and leave the given one alone; the
block writes it into the layer's state tensors in place
(``transformer.commit_state``), since captured graphs hold their
addresses.

The recurrence's contractions over a head's lanes (``n . q`` and
``C q``) are an elementwise product summed by ``layers.lane_sum``, a
fixed tree of elementwise adds: a row's value never depends on how many rows
run with it (a reduction or batched GEMM kernel may pick its launch
shape, and with it its summation order, from the batch).  The
scheduler's oracle contract rests on this: a request decoded beside
others gives its solo tokens.

``collect_states`` (the speculative verify step's): with a state, every
leaf of the returned state gains a position axis, [B, S, ...], index t
the state after token t.  The tokens run through the same per-token
loop either way, so index t equals t + 1 one-token steps bit for bit.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import layers

Params = dict[str, Any]

NEG_INIT = -1e30
# the value each leaf of a fresh mLSTM or sLSTM state holds
STATE_INIT = {"c": 0.0, "n": 0.0, "m": NEG_INIT}


def _dims(cfg: ModelConfig) -> tuple[int, int, int]:
    inner = 2 * cfg.d_model
    heads = cfg.num_heads
    return inner, heads, inner // heads


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(gen: torch.Generator, cfg: ModelConfig,
               device: torch.device | str = "cpu") -> Params:
    d = cfg.d_model
    inner, heads, _ = _dims(cfg)
    return {
        "wqkv": layers.linear_init(gen, d, 3 * inner, device=device),
        "wi": layers.linear_init(gen, d, heads, bias=True, device=device),
        "wf": layers.linear_init(gen, d, heads, bias=True, device=device),
        "wzo": layers.linear_init(gen, d, inner, device=device),
        "out_proj": layers.linear_init(gen, inner, d, device=device),
    }


def make_mlstm_state(cfg: ModelConfig, batch: int,
                     device: torch.device | str = "cpu") -> Params:
    _, heads, hd = _dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, heads, hd, hd), **f32),
            "n": torch.zeros((batch, heads, hd), **f32),
            "m": torch.full((batch, heads), NEG_INIT, **f32)}


def _mlstm_step(carry, q, k, v, i_pre, f_pre):
    """One token of the stabilised recurrence: q/k/v [B, H, hd] (f32),
    i_pre/f_pre [B, H] f32 -> ((c, n, m), h [B, H, hd] f32)."""
    c0, n0, m0 = carry
    logf = F.logsigmoid(f_pre)
    m1 = torch.maximum(logf + m0, i_pre)
    fp = torch.exp(logf + m0 - m1)
    ip = torch.exp(i_pre - m1)
    c1 = c0 * fp[..., None, None] \
        + ip[..., None, None] * (v[..., :, None] * k[..., None, :])
    n1 = n0 * fp[..., None] + ip[..., None] * k
    den = torch.maximum(torch.abs(layers.lane_sum(n1 * q)), torch.exp(-m1))
    h = layers.lane_sum(c1 * q[..., None, :]) / den[..., None]
    return (c1, n1, m1), h


def _stack_carries(carries) -> Params:
    """The (c, n, m) carry after each token -> leaves [B, S, ...]."""
    return {name: torch.stack([c[i] for c in carries], dim=1)
            for i, name in enumerate("cnm")}


def mlstm(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
          state: Params | None = None, collect_states: bool = False,
          ) -> tuple[torch.Tensor, Params | None]:
    """x: [B, S, D] -> (y [B, S, D], new state or None).  Without a
    state, the chunked parallel form; with one, the recurrence token by
    token (a decode step is its one-token case).  ``collect_states``
    (needs ``state``): the state after every token, [B, S, ...] a
    leaf."""
    b, s, _ = x.shape
    inner, heads, hd = _dims(cfg)
    qkv = layers.linear(p["wqkv"], x, cfg.pum)
    q, k, v = torch.split(qkv, inner, dim=-1)
    q = q.reshape(b, s, heads, hd)
    k = k.reshape(b, s, heads, hd) / math.sqrt(hd)
    v = v.reshape(b, s, heads, hd)
    i_pre = layers.linear(p["wi"], x, cfg.pum).to(torch.float32)
    f_pre = layers.linear(p["wf"], x, cfg.pum).to(torch.float32)
    o_gate = torch.sigmoid(layers.linear(p["wzo"], x, cfg.pum))

    if state is None:
        y = _mlstm_parallel(q, k, v, i_pre, f_pre)
        new_state = None
    else:
        carry = tuple(state[n].to(torch.float32) for n in "cnm")
        qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
        hs, carries = [], []
        for t in range(s):
            carry, h = _mlstm_step(carry, qf[:, t], kf[:, t], vf[:, t],
                                   i_pre[:, t], f_pre[:, t])
            hs.append(h)
            if collect_states:
                carries.append(carry)
        y = torch.stack(hs, dim=1).to(x.dtype)
        new_state = _stack_carries(carries) if collect_states \
            else dict(zip("cnm", carry))

    y = (y.reshape(b, s, inner) * o_gate).to(x.dtype)
    return layers.linear(p["out_proj"], y, cfg.pum), new_state


def _mlstm_parallel(q, k, v, i_pre, f_pre, chunk: int = 1024
                    ) -> torch.Tensor:
    """Parallel form, chunked (flash-style online accumulation).

    Decay d_ij = exp(F_i - F_j + i_j - m_i) for j <= i, with F the
    cumulative log-forget.  Scores (q.k)*d are signed, so only the decay
    exponential is max-stabilised.  O(chunk^2) score memory."""
    b, s, h, hd = q.shape
    cq = ck = min(chunk, s)
    nq = -(-s // cq)
    nk = -(-s // ck)
    pad = nq * cq - s
    f_cum = torch.cumsum(F.logsigmoid(f_pre), dim=1)         # [B,S,H]
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        f_cum = F.pad(f_cum, (0, 0, 0, pad))
        i_pre = F.pad(i_pre, (0, 0, 0, pad), value=NEG_INIT)
    kc = k.reshape(b, nk, ck, h, hd).to(torch.float32)
    vc = v.reshape(b, nk, ck, h, hd).to(torch.float32)
    fc = f_cum.reshape(b, nk, ck, h)
    ic = i_pre.reshape(b, nk, ck, h)
    dev = q.device
    outs = []
    for qi in range(nq):
        qblk = q[:, qi * cq:(qi + 1) * cq].to(torch.float32)
        fq = f_cum[:, qi * cq:(qi + 1) * cq]                 # [B,CQ,H]
        m = torch.full((b, cq, h), NEG_INIT, dtype=torch.float32,
                       device=dev)
        den = torch.zeros((b, cq, h), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, cq, h, hd), dtype=torch.float32, device=dev)
        qpos = qi * cq + torch.arange(cq, device=dev)
        for kj in range(nk):
            logd = (fq[:, :, None, :] - fc[:, kj][:, None, :, :]
                    + ic[:, kj][:, None, :, :])             # [B,CQ,CK,H]
            kpos = kj * ck + torch.arange(ck, device=dev)
            causal = qpos[:, None] >= kpos[None, :]
            logd = torch.where(causal[None, :, :, None], logd,
                               torch.full((), NEG_INIT, device=dev))
            m_new = torch.maximum(m, logd.amax(dim=2))
            w = torch.exp(logd - m_new[:, :, None, :])
            sc = torch.einsum("bqhd,bthd->bqth", qblk, kc[:, kj]) * w
            corr = torch.exp(m - m_new)
            den = den * corr + sc.sum(dim=2)
            acc = acc * corr[..., None] + torch.einsum(
                "bqth,bthd->bqhd", sc, vc[:, kj])
            m = m_new
        denom = torch.maximum(torch.abs(den), torch.exp(-m))
        outs.append(acc / denom[..., None])
    out = torch.cat(outs, dim=1)
    return out[:, :s].to(q.dtype)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(gen: torch.Generator, cfg: ModelConfig,
               device: torch.device | str = "cpu") -> Params:
    d = cfg.d_model
    inner, _, _ = _dims(cfg)
    return {
        "wz": layers.linear_init(gen, d, inner, bias=True, device=device),
        "wi": layers.linear_init(gen, d, inner, bias=True, device=device),
        "wf": layers.linear_init(gen, d, inner, bias=True, device=device),
        "wo": layers.linear_init(gen, d, inner, bias=True, device=device),
        "out_proj": layers.linear_init(gen, inner, d, device=device),
    }


def make_slstm_state(cfg: ModelConfig, batch: int,
                     device: torch.device | str = "cpu") -> Params:
    inner, _, _ = _dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, inner), **f32),
            "n": torch.zeros((batch, inner), **f32),
            "m": torch.full((batch, inner), NEG_INIT, **f32)}


def _slstm_step(carry, gates):
    c, n, m = carry
    z, i_pre, logf, o = gates
    m_new = torch.maximum(logf + m, i_pre)
    fp = torch.exp(logf + m - m_new)
    ip = torch.exp(i_pre - m_new)
    c_new = fp * c + ip * torch.tanh(z)
    n_new = fp * n + ip
    h = o * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, m_new), h


def slstm(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
          state: Params | None = None, collect_states: bool = False,
          ) -> tuple[torch.Tensor, Params | None]:
    """x: [B, S, D] -> (y, new state or None): the recurrence token by
    token, from a fresh state when none is given.  ``collect_states``:
    as in :func:`mlstm`."""
    b, s, _ = x.shape
    inner, _, _ = _dims(cfg)
    z = layers.linear(p["wz"], x, cfg.pum).to(torch.float32)
    i_pre = layers.linear(p["wi"], x, cfg.pum).to(torch.float32)
    logf = F.logsigmoid(
        layers.linear(p["wf"], x, cfg.pum).to(torch.float32))
    o = torch.sigmoid(layers.linear(p["wo"], x, cfg.pum)
                      .to(torch.float32))
    if state is None:
        carry = tuple(make_slstm_state(cfg, b, x.device).values())
    else:
        carry = tuple(state[n].to(torch.float32) for n in "cnm")
    hs, carries = [], []
    for t in range(s):
        carry, h = _slstm_step(carry, (z[:, t], i_pre[:, t], logf[:, t],
                                       o[:, t]))
        hs.append(h)
        if collect_states:
            carries.append(carry)
    y = torch.stack(hs, dim=1).to(x.dtype)
    if state is None:
        new_state = None
    elif collect_states:
        new_state = _stack_carries(carries)
    else:
        new_state = dict(zip("cnm", carry))
    return layers.linear(p["out_proj"], y, cfg.pum), new_state
