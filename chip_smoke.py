#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. device  — requires CUDA; prints the card's name and power limit as
   ``nvidia-smi`` gives them.
2. build   — compiles every ``src/repro_torch/**/csrc/*.cu`` for sm_90a,
   one ``nvcc`` per source, all started together.
3. kernels — holds each hand-written kernel against its plain PyTorch
   version at the main paths' shapes (bitslice MVM at M in {1, 4, 16}
   and both GF(2) MVM entries, int8 and state bytes, bit for bit, paged
   attention at the serve run's window T=81 and a long one, T=1024,
   within the stated tolerance and its pools bit for bit), checks that
   two calls on the same inputs give the same bits, and
   times kernel, plain version and one PyTorch library call that
   computes the same function, beside the card's least time (bound);
   then sums K1's and K2's times over the 7 x 36 projections of a
   decode step (M=4) and of a prefill chunk (M=16) beside their bound.
   The same for xLSTM-350M's 120 projections (1024 x 6144, 1024 x 4,
   1024 x 2048, 2048 x 1024): at N = 4, mLSTM's gates, the packed
   entries pad the planes to 16 columns a call, timed beside the same
   launches on planes padded once.  The same for OLMoE-1B-7B's 64
   projections (2048 x 2048, M = 4 and 16), and K3 at the MoE head
   layouts (KV = 16, G = 1, hd = 128 and KV = 8, G = 2, hd = 64, at
   the same (S, T) cases); then K3's store where 6 inactive rows and a
   past-width one write the same trash cells (S = 1 and 16): its pools
   bit-equal to the plain version's, the last row's value in each
   shared cell, as the reference's sequential scatter leaves it.  Every
   K3 case holds the pools bit for bit, trash block included.
4. serve pum  — ``repro_torch.launch.serve.main`` on Qwen2.5-3B at full
   width with prepacked ``pum`` weights: 4 slots, KV blocks of 16,
   chunked prefill, a burst of 6 requests of 20..64 prompt tokens, 16
   greedy tokens each.  The scheduler runs every decode step and prefill
   chunk as a CUDA graph replay, building one graph for decode and one
   per chunk length; the decode graph holds the sampler, whose greedy
   rows take the argmax (phase 8).  Checks every completion, the launch counts per
   decode step and prefill chunk (replays counted), and that each step
   was built once.  Then: one chunk and one decode step from a fresh
   pool with graphs on and off, logits bit-equal; the same trace again
   on the same scheduler (nothing new built, the same tokens) and on
   one with ``cuda_graphs=False`` (the same tokens and launches), their
   decode ms/step, tokens/s and peak memory side by side; one prefill
   chunk and one decode step on the ``cuda`` and the ``torch`` backends,
   logits compared; the f32 lm head's device time as a share of one
   decode graph replay's; the card's busy share under the profiler,
   graphs and eager.
5. serve int8 — the same with ``int8`` weights.
5b. serve bf16 — the same with the float weights unpacked: no MVM
   kernel launches, K3 one a layer a step and chunk.
6. aes — ``repro_torch.launch.aes.main`` at 2^24 blocks (256 MiB of
   plaintext) for AES-128, -192 and -256: the bulk cipher through K4's
   state-byte entry, its ciphertext against the numpy oracle on 65 536
   strided blocks, decrypt(encrypt(x)) == x on every block, exactly Nr
   (Nr - 1) launches of that entry per encrypt (decrypt) call and none
   of K4's int8 entry, the gate-accurate DCE path on 256 blocks equal
   to the bulk ciphertext, the FIPS-197 vectors through every path on
   the card, the card's busy share over one bulk encryption under the
   profiler, and (AES-128) the device time of each op of one round.
7. cnn — ResNet-20 for CIFAR-10 at its published width (16/32/64
   channels, 20 layers) on 1024 synthetic images, every conv an im2col
   MVM: first K2's unpacked entry at each layer's shape (up to 2^20 rows,
   past CUDA's 65535 CTAs on grid z; N down to 10) bit for bit against
   its plain version, timed beside its byte bound and ``torch._int_mm``;
   then the ``pum`` forward with exactly 22 K2 launches (and none of
   K1), its logits bit-equal to the ``torch`` backend's and across two
   runs, and finite; the float forward (f32 ``torch.matmul``, TF32 off)
   and the two modes' argmax agreement; images/s of both; K2's share of
   a forward's device time and the top kernels under the profiler; and
   the paper's §7.5 agreement sweep (programming noise sigma in {0,
   0.02, 0.05, 0.1, 0.3}, 256 images) with its gates: agreement
   without noise at least 0.75, at sigma 0.3 no higher, noise drawn
   (on differs from off) from the generator (the same seed gives the
   same bits).
8. sampled — the sampler (``serve/prng.py``, ``sample_token``) on the
   card: threefry's known answers; random bits and uniforms over a
   decode step's [4, 152064] logits (one key, and a key a row)
   bit-equal to the CPU's; Gumbel values within 2 ulps of the CPU's;
   categorical draws over 64 rows equal to the CPU's but at near-ties,
   counted; 2^20 rows, a key each, drawing from one 16-way categorical
   at t = 0.7, every frequency within 5 sigma of ``softmax(l / t)``;
   the sampler's device ms at a decode step's shapes.  Then in ``pum``
   and ``int8``: the CLI at ``--temperature 0.7`` (the main path), and
   on its scheduler phase 4's six requests at temperatures [0, 0.7, 1,
   0, 0.7, 1], a seed each, gated: each completion equal to the request
   served alone through the same kernels, and on the ``torch`` backend
   (where the scheduler and the contiguous solo loop run the same
   arithmetic) to its solo ``generate_loop``; graphs and eager equal in
   tokens and launches; the temperature-0 requests equal to phase 4's
   tokens; one decode program and nothing new built; the same seeds the
   same tokens and other seeds other tokens; at t = 1 some token off the
   greedy one; 252 MVM + 36 attention launches a step or chunk; in
   ``pum``, where the cuda backend's completions first differ from the
   contiguous solo loop on the cuda backend (printed, not gated); decode
   ms/step
   (graphs and eager), tokens/s, a decode replay's device ms and the
   sampler's share of it; greedy decode ms/step of phases 4-5b beside
   those recorded before the decode graph held the sampler (PERF.md).
9. contiguous — the reference's default serving paths, in ``pum`` and
   ``int8``: one layer's online softmax (``_chunked_attention``) at a
   4096-token prompt's shapes against the plain composition, within the
   bound derived at CHUNK_ATTN_REL; K1 and K2 alone at M = 4096 (a
   monolithic prefill's rows) bit for bit, timed beside their bounds and
   ``torch._int_mm``.  Then the CLI with ``--kv-block-size 0`` on phase
   4's trace (contiguous windows: one prefill program a prompt length,
   one decode program, no K3), gated: 252 MVM launches a step and a
   prefill and none of K3, each program built once, the same trace
   again building nothing, graphs == eager, and the tokens equal to
   the paged scheduler's on the ``torch`` backend with monolithic
   prefill on both; then phase 8's six requests plus one of 4096
   prompt tokens (its prefill through the online softmax) on a
   scheduler of 4113 positions, each completion equal to the request
   served alone through ``generate_loop`` on the ``cuda`` backend, and
   the long prefill timed (time to first token) and profiled; then the
   static batch (``--batch-slots 0 --batch 4 --prompt-len 64 --gen
   16``), compiled prefill and decode step and ``--loop``, at t = 0 and
   0.7, gated equal token for token, seeds reproducing with nothing new
   built, half the steps replaying the same two programs, graphs ==
   eager; its rate build included and steady.  Prints decode ms/step (graphs and eager), tokens/s,
   peak memory, and a decode replay's device ms beside the paged
   scheduler's on the same trace, timed in turns (paged, contiguous,
   contiguous, paged).
10. xlstm — xLSTM-350M at full width and depth (18 mLSTM + 6 sLSTM
   layers, random weights), in ``pum`` and ``int8``: the CLI on phase
   4's trace paged (blocks of 16, chunked prefill; no KV, so 0 blocks a
   request) and with ``--kv-block-size 0``, then on both schedulers
   phase 8's six sampled requests, gated: each completion equal to the
   request served alone through ``generate_loop`` on the ``cuda``
   backend, in both layouts; the greedy runs paged == contiguous; a
   second run builds nothing; one decode program; graphs == eager in
   tokens and launches; each recurrent step built and called once
   leaves the state one eager call leaves (fresh schedulers, step by
   step); 120 MVM launches a step, chunk or prompt and no K3; states
   and every step's last logits finite; backend parity; then the static
   batch (scan == ``--loop``, t = 0).  Prints decode ms/step (graphs and
   eager), tokens/s, a decode replay's device ms with K1's or K2's
   share (profiler) and the recurrences' (the cells timed alone), a
   64-token prompt's prefill device ms, graph build seconds, the
   recurrent bytes a slot beside Qwen2.5-3B's KV bytes, and the phase's
   seconds.
11. moe — OLMoE-1B-7B at full width and depth (16 layers, d_model
   2048, 64 experts top-8, random weights; 25.8 GB of f32 expert
   stacks), in ``pum`` and ``int8``: the CLI on phase 4's trace paged
   (blocks of 16, chunked prefill) and with ``--kv-block-size 0``, at
   the config's own capacity factor 1.25 (capacity 1 an expert at a
   decode step), gated: 64 MVM launches a step, chunk or prompt (q, k,
   v, o: none for the f32 router or the float experts), 16 K3 a paged
   one and none contiguous; each program built once; the same trace
   from a fresh state (idle rows take capacity, so a run depends on
   what the last one left) the CLI's tokens twice, building nothing;
   graphs == eager in tokens and launches; every step's logits finite;
   the ``cuda`` and ``torch`` backends on one chunk and one step,
   routed alike (``routing``: the torch run and a run with layer 0's
   input nudged by one bf16 ulp take the cuda run's experts): logits
   within the nudge's change, greedy tokens equal, router
   probabilities within the nudge's change (the router's one-ulp
   sensitivity), and every row where the torch router would choose
   other experts at a near-tie (the cuda run's probabilities of the
   two experts within that sensitivity), counted.  Then at capacity
   factor E / k (no drops), paged and contiguous, each against every
   request alone through ``generate_loop`` on ``cuda``: an eager run
   with every row routed as its request alone routed it keeps the
   router probabilities within the sensitivity, differs in its own
   choices only at router near-ties, and first differs in tokens only
   where the solo's top-2 margin is within the one-ulp logit bound
   (both measured by the backend parity at this factor); the free runs
   (graphs == eager) first differ where the held run does or after a
   router near-tie.  The expert products' row count is the capacity
   and K3 sums in another order than the solo's attention, so the
   logits are not bit-equal; the share of solo margins and router gaps
   within the thresholds is printed.  Then the static batch (scan ==
   ``--loop``, t = 0).  granite-moe-1b-a400m (24 layers, 32 experts,
   GQA G = 2, hd 64) once through the paged CLI in ``pum``: launches,
   builds, a fresh-state rerun, finite logits.  Prints decode ms/step
   (graphs and eager), tokens/s, a decode replay's device ms and its
   split under the profiler (K1/K2, K3, the cast's copies, float
   GEMMs, sort and ranks, gathers), the expert cast, the expert
   products and the rest of one layer's ``moe_ffn`` timed alone, a
   64-token prefill's device ms, the share of assignments dropped a
   decode step, peak memory and the phase's seconds.
12. a ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.
   Every kernel of the main paths (phases 4-11) must have launched there;
   K4's int8 entry is on none of them (its ``launches`` is 0, and any
   launch there fails the run): phase 3 holds it against its plain
   version.  K2's row carries its rows at the CNN's layer shapes
   (``cnn_shapes``), K1's and K2's their rows at M = 4096
   (``prefill_shape``), at xLSTM-350M's shapes (``xlstm_shapes``) and
   at OLMoE-1B-7B's (``moe_shapes``), K3's at the MoE head layouts
   (``moe_shapes``).

``--only kernels`` stops after phase 3 (bring-up of a kernel change);
``--only cnn`` runs phases 1, 2 and 7 alone, ``--only contiguous``
phases 1, 2 and 9, ``--only xlstm`` phases 1, 2, phase 3's xLSTM
shapes and 10, ``--only moe`` phases 1, 2, phase 3's MoE shapes and
11.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# published peaks of the card (NVIDIA data sheets, dense):
# (device-memory bytes/s, bf16 flop/s, int8 op/s)
PEAKS = {"SXM": (3.35e12, 989e12, 1979e12),
         "PCIe": (2.0e12, 756e12, 1513e12)}

# K3's tolerance against its plain version, bf16 pools: the kernel sums
# scores and p*V in f32 in another order than the composition, so a
# probability can round to the neighbouring bf16 value (2^-8 relative)
# and the output to the neighbouring bf16 value; with O(1) inputs that
# is within 2e-2 absolute + 2e-2 relative.  Each case must also be
# within a bound read in the same run, which scales with the outputs
# (at T=1024 they are some 20 times smaller than at T=81): the plain
# version's own change when every V cell moves up by one bf16 ulp (times
# 1 + ULP), one to two ulps of the largest outputs.
ATTN_ATOL = 2e-2
ATTN_RTOL = 2e-2

# cuda-vs-torch backend logits of the full model (bf16 activations):
# every linear is exact integer arithmetic on equal inputs (bf16 mode:
# the same float matmul on both backends), so the two
# backends can differ only through attention's f32 summation order,
# which can move a bf16 activation by one ulp.  The bound is read in
# the same run: the logits' change when one bf16 ulp is added to every
# other channel of layer 0's attention input (its norm scale times
# 1 + ULP).  The greedy token must be the same on every row.
ULP = 2.0 ** -7


def log(msg: str) -> None:
    print(msg, flush=True)


def peaks(name: str) -> tuple[float, float, float]:
    return PEAKS["PCIe" if "PCIe" in name else "SXM"]


def share(bound: float, ms: float) -> str:
    """The kernel's share of its bound: bound time over measured time."""
    return f"{100 * bound / ms:.1f} %"


def device_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Per-call device time of ``fn``: ``iters`` calls captured in one
    CUDA graph and replayed between CUDA events, so host dispatch does
    not enter the number."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def event_ms(fn, reps: int = 5) -> float:
    """Per-call device time of ``fn`` between CUDA events, after one
    warm-up call: for calls of milliseconds on inputs far larger than
    the L2 cache, where launch time does not matter and a graph of many
    calls would hold their outputs at once."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Rotating:
    """Copies of a call's inputs cycled between launches so that their
    total exceeds the 50 MB L2 cache: every launch finds its weights
    cold, as on the main path, where 36 layers' weights pass between
    two uses of one."""

    def __init__(self, make, nbytes: int, total: int = 192 << 20):
        self.items = [make() for _ in range(max(1, min(64, -(-total //
                                                             max(nbytes,
                                                                 1)))))]
        self.i = 0

    def next(self):
        self.i = (self.i + 1) % len(self.items)
        return self.items[self.i]


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

MVM_SHAPES = [(2048, 2048), (2048, 256), (2048, 11008), (11008, 2048)]
MVM_ROWS = [1, 4, 16]
# Qwen2.5-3B's projections of one layer by (K, N): q and o, k and v,
# gate and up, down; 36 layers
MVM_PER_LAYER = {(2048, 2048): 2, (2048, 256): 2, (2048, 11008): 2,
                 (11008, 2048): 1}
LAYERS = 36
STEP_ROWS = {4: "decode step", 16: "prefill chunk"}


def deterministic(fn) -> bool:
    """Two calls of ``fn`` on the same inputs give the same bits."""
    import torch
    a, b = fn(), fn()
    torch.cuda.synchronize()
    return torch.equal(a, b)


def mvm_ops(m: int, k: int, n: int) -> int:
    """The int8 operations of a bit-sliced MVM over any number of planes:
    sum_s (x @ P_s) << bps*s equals x @ (sum_s P_s << bps*s) exactly in
    int32, and that sum is the int8 weight the planes were sliced from,
    so the least work is one [M,K] x [K,N] int8 product."""
    return 2 * m * k * n


def mvm_case(dev, g, m: int, k: int, n: int, planes, one) -> dict:
    """K1 (``bitslice_mvm_planes_scaled``, 4 planes) and K2
    (``bitslice_mvm_planes``, the int8 weight as one plane) at one
    shape: bit for bit against their plain versions, two calls equal,
    then timed with the weights rotated past the L2 cache, beside the
    plain versions, ``torch._int_mm`` and their bounds."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.kernels.bitslice_mvm import ops
    bw, _, int8_rate = peaks(torch.cuda.get_device_name(dev))
    x = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                      dtype=torch.int32).to(torch.int8)
    scale = torch.rand((m, 1), generator=g, device=dev) * 1e-3
    got1 = ops.bitslice_mvm_planes_scaled(x, planes, scale, backend="cuda")
    ref1 = ops.bitslice_mvm_planes_scaled(x, planes, scale, backend="torch")
    got2 = ops.bitslice_mvm_planes(x, one, bits_per_slice=8, backend="cuda")
    ref2 = ops.bitslice_mvm_planes(x, one, bits_per_slice=8, backend="torch")
    got4 = ops.bitslice_mvm_planes(x, planes, backend="cuda")
    torch.cuda.synchronize()
    exact = (torch.equal(got1, ref1) and torch.equal(got2, ref2)
             and torch.equal(got4, ref2))
    err1 = (got1 - ref1).abs().max().item()
    err2 = (got2 - ref2).abs().max().item()
    if not exact:
        raise AssertionError(
            f"bitslice_mvm not bit-exact at M={m} K={k} N={n}: scaled "
            f"max|diff|={err1}, int max|diff|={err2}, 4-plane int equal="
            f"{torch.equal(got4, ref2)}")
    if not (deterministic(lambda: ops.bitslice_mvm_planes_scaled(
            x, planes, scale, backend="cuda"))
            and deterministic(lambda: ops.bitslice_mvm_planes(
                x, one, bits_per_slice=8, backend="cuda"))):
        raise AssertionError(f"bitslice_mvm differs between two calls at "
                             f"M={m} K={k} N={n}")
    npad = -(-n // ops.VEC) * ops.VEC
    splits = ops.mvm_plan(m, k, npad, 4, registry.device_props(
        dev.index)).splits
    # timings with the weights rotated past the L2 cache
    rp = Rotating(lambda: planes.clone(), planes.numel())
    rw = Rotating(lambda: one.clone(), one.numel())
    xpad = torch.zeros((max(32, -(-m // 8) * 8), k), dtype=torch.int8,
                       device=dev)
    xpad[:m] = x
    t1 = device_ms(lambda: ops.bitslice_mvm_planes_scaled(
        x, rp.next(), scale, backend="cuda"))
    t2 = device_ms(lambda: ops.bitslice_mvm_planes(
        x, rw.next(), bits_per_slice=8, backend="cuda"))
    p1 = device_ms(lambda: ops.bitslice_mvm_planes_scaled(
        x, rp.next(), scale, backend="torch"), iters=5)
    p2 = device_ms(lambda: ops.bitslice_mvm_planes(
        x, rw.next(), bits_per_slice=8, backend="torch"), iters=5)
    # _int_mm takes N in multiples of 8: the library call at N < 8 reads
    # the weight padded to 8 columns
    wlib = torch.zeros((k, max(8, -(-n // 8) * 8)), dtype=torch.int8,
                       device=dev)
    wlib[:, :n] = one[0]
    rl = Rotating(lambda: wlib.clone(), wlib.numel())
    lib = device_ms(lambda: torch._int_mm(xpad, rl.next()))
    # the planes recombine to wq exactly (mvm_ops), so the function's
    # work is one int8 GEMM; the planes' bytes count
    b1 = max((m * k + 4 * k * n + 4 * m + 4 * m * n) / bw,
             mvm_ops(m, k, n) / int8_rate) * 1e3
    b2 = max((m * k + k * n + 4 * m * n) / bw,
             2 * m * k * n / int8_rate) * 1e3
    if n % ops.VEC:
        # the same launches on planes padded once: the per-call pad's cost
        p1pad, p2pad = ops._padded(planes), ops._padded(one)
        t1p = device_ms(lambda: ops._launch(x, p1pad, scale.reshape(-1), 2))
        t2p = device_ms(lambda: ops._launch(x, p2pad, None, 8))
        log(f"mvm M={m} K={k} N={n}: planes padded to {npad} columns once, "
            f"K1 {t1p:.4f} ms, K2 {t2p:.4f} ms; the per-call pad adds "
            f"{t1 - t1p:.4f} / {t2 - t2p:.4f} ms")
    log(f"mvm M={m} K={k} N={n} (K1 split {splits} ways over K): exact, "
        f"two calls bit-equal | K1 scaled {t1:.4f} ms (plain {p1:.4f}, "
        f"bound {b1:.4f}, {share(b1, t1)} of bound) | K2 int8 {t2:.4f} ms "
        f"(plain {p2:.4f}, bound {b2:.4f}, {share(b2, t2)} of bound) | "
        f"_int_mm(M={xpad.shape[0]}) {lib:.4f} ms")
    return {"K1": dict(M=m, K=k, N=n, max_abs_err=err1, ms=t1, plain_ms=p1,
                       bound_ms=b1, bound_by="bytes", library_ms=lib),
            "K2": dict(M=m, K=k, N=n, max_abs_err=err2, ms=t2, plain_ms=p2,
                       bound_ms=b2, bound_by="bytes", library_ms=lib)}


def mvm_weights(dev, g, k: int, n: int):
    """A random int8 weight as K1's four planes and K2's one plane."""
    import torch
    from repro_torch.core import bitslice
    wq = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                       dtype=torch.int32)
    planes = bitslice.slice_planes_signed(wq, 8, 2).to(torch.int8)
    return planes, wq.to(torch.int8)[None]


def mvm_sweep(dev, shapes: dict, layers: int, label: str,
              rows: list[int]) -> list[dict]:
    """``mvm_case`` over ``shapes`` ((K, N) -> projections of that shape
    a forward pass) at each M of ``rows``; then K1's and K2's summed
    device time over a decode step (M=4) and a prefill chunk (M=16)
    beside their bound.  Returns every case's row."""
    import torch
    g = torch.Generator(device=dev).manual_seed(0)
    step = {(name, m): [0.0, 0.0] for m in STEP_ROWS for name in ("K1", "K2")}
    cases = []
    for (k, n), count in shapes.items():
        planes, one = mvm_weights(dev, g, k, n)
        for m in rows:
            case = mvm_case(dev, g, m, k, n, planes, one)
            cases.append(case)
            if m in STEP_ROWS:
                for name in ("K1", "K2"):
                    step[name, m][0] += count * case[name]["ms"]
                    step[name, m][1] += count * case[name]["bound_ms"]
    per_pass = sum(shapes.values())
    for (name, m), (ms, bound) in step.items():
        log(f"mvm {name} device time per {STEP_ROWS[m]} of {label} at M={m} "
            f"({per_pass} projections, {layers} layers): {ms:.3f} ms (bound "
            f"{bound:.3f} ms)")
    return cases


def check_mvm(dev) -> dict[str, dict]:
    """Phase 3's MVM checks at Qwen2.5-3B's shapes; K1's and K2's rows
    of the kernels line (M=4, 2048 x 11008)."""
    cases = mvm_sweep(dev, {s: LAYERS * c for s, c in MVM_PER_LAYER.items()},
                      LAYERS, "Qwen2.5-3B", MVM_ROWS)
    case = next(c for c in cases if (c["K1"]["M"], c["K1"]["K"],
                                     c["K1"]["N"]) == (4, 2048, 11008))
    return {name: {k: v for k, v in case[kern].items()
                   if k not in ("M", "K", "N")}
            for name, kern in (("bitslice_mvm_scaled", "K1"),
                               ("bitslice_mvm", "K2"))}


ATTN_CASES = [(1, 81), (16, 81), (1, 1024)]       # (S, T window)
# head layouts (KV heads, queries a KV head, head dim): Qwen2.5-3B's,
# then OLMoE-1B-7B's (MHA) and granite-moe-1b-a400m's
QWEN_HEADS = (2, 8, 128)
MOE_HEADS = [(16, 1, 128), (8, 2, 64)]


def _attn_case(dev, s: int, kv_len: int, seed: int, heads=QWEN_HEADS):
    """A head layout (default Qwen2.5-3B's) at the serve run's geometry:
    4 rows, blocks of 16, a table as wide as the T window (T = 81 is the
    serve run's, 6 columns; T = 1024 a long context).  Row 2 is inactive
    (its table is all trash); row 3 writes past its table width."""
    import torch
    (kvh, grp, hd), b, bs = heads, 4, 16
    w = -(-kv_len // bs)
    nb = 1 + b * w
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    q = rnd(b, s, kvh, grp, hd)
    k_new, v_new = rnd(b, s, kvh, hd), rnd(b, s, kvh, hd)
    k_pool, v_pool = rnd(nb, bs, kvh, hd), rnd(nb, bs, kvh, hd)
    table = torch.arange(1, nb, device=dev, dtype=torch.int32).reshape(b, w)
    table[2] = 0
    if s == 1:
        ci = [kv_len // 2, kv_len - 11, 5, w * bs + 3]
    else:
        ci = [kv_len // 2 - 8, kv_len - s - 1, 0, w * bs - 8]
    cache_index = torch.tensor(ci, dtype=torch.int32, device=dev)
    return (q, k_new, v_new, k_pool, v_pool, table, table.clone(),
            cache_index)


def _attn_bound(args, kv_len: int, bw: float, flops: float) -> float:
    q, k_new, _, k_pool, _, table, _, ci = args
    b, s, kvh, grp, hd = q.shape
    el = k_pool.element_size()
    nbytes = (q.numel() + 2 * k_new.numel()) * el          # q, new K/V in
    nbytes += 2 * k_new.numel() * el                       # cells stored
    nbytes += q.numel() * el + 2 * table.numel() * 4 + b * 4   # out, tables
    ops = 0
    for row in range(b):
        c = int(ci[row])
        nbytes += 2 * min(c + s, kv_len) * kvh * hd * el   # K and V read
        for si in range(s):
            ops += 4 * hd * min(c + si + 1, kv_len) * kvh * grp
    return max(nbytes / bw, ops / flops) * 1e3


def _v_nudged(args):
    """K3's inputs with every V cell, stored and new, one bf16 ulp up."""
    v_new, v_pool = args[2], args[4]
    return (args[:2] + ((v_new.float() * (1 + ULP)).to(v_new.dtype),)
            + args[3:4] + ((v_pool.float() * (1 + ULP)).to(v_pool.dtype),)
            + args[5:])


def check_attention(dev, gpu_name: str, layouts=(QWEN_HEADS,),
                    cases=ATTN_CASES) -> list[dict]:
    """K3 at each head layout and (S, T) case against its plain version:
    outputs within the stated tolerance, the pools bit for bit (the
    trash block too: where the inactive and the past-width row write one
    trash cell, the later row wins on both), two calls bit-equal; timed
    beside the plain version, ``scaled_dot_product_attention`` and the
    bound.  Returns every case's row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import registry
    from repro_torch.kernels.paged_attention import ops, ref
    bw, flops, _ = peaks(gpu_name)
    rows = []
    active = [0, 1, 3]
    for heads, (s, kv_len) in ((h, c) for h in layouts for c in cases):
        kvh, grp, hd = heads
        args = _attn_case(dev, s, kv_len, seed=s, heads=heads)
        kp_ref, vp_ref, out_ref = ops.paged_attention(
            *args, kv_len=kv_len, backend="torch")
        out_nudged = ops.paged_attention(*_v_nudged(args), kv_len=kv_len,
                                         backend="torch")[2]
        kp, vp = args[3].clone(), args[4].clone()
        kargs = args[:3] + (kp, vp) + args[5:]
        _, _, out = ops.paged_attention(*kargs, kv_len=kv_len,
                                        backend="cuda")
        torch.cuda.synchronize()
        pools_equal = torch.equal(kp, kp_ref) and torch.equal(vp, vp_ref)
        o, r = out[active].float(), out_ref[active].float()
        err = (o - r).abs().max().item()
        tol = (out_nudged[active].float() - r).abs().max().item()
        close = (torch.allclose(o, r, atol=ATTN_ATOL, rtol=ATTN_RTOL)
                 and 0 < tol and err <= tol)
        finite = bool(torch.isfinite(out[active].float()).all())
        label = (f"paged_attention B=4 S={s} KV={kvh} G={grp} hd={hd} bs=16 "
                 f"T={kv_len}")
        if not (pools_equal and close and finite):
            raise AssertionError(
                f"{label}: pools equal={pools_equal}, max|diff|={err} (atol "
                f"{ATTN_ATOL}, rtol {ATTN_RTOL}, one-ulp V bound {tol}), "
                f"finite={finite}")
        if not deterministic(lambda: ops.paged_attention(
                *kargs, kv_len=kv_len, backend="cuda")[2][active]):
            raise AssertionError(f"{label} differs between two calls")
        plan = ops.attention_plan(s, grp, hd, kv_len,
                                  registry.device_props(dev.index))
        # timings: pools rotated past the L2 cache like the weights
        nbytes = 2 * args[3].numel() * args[3].element_size()
        rot = Rotating(lambda: (args[3].clone(), args[4].clone()), nbytes)

        def kern():
            k_p, v_p = rot.next()
            return ops.paged_attention(*args[:3], k_p, v_p, *args[5:],
                                       kv_len=kv_len, backend="cuda")

        def plain():
            k_p, v_p = rot.next()
            return ops.paged_attention(*args[:3], k_p, v_p, *args[5:],
                                       kv_len=kv_len, backend="torch")

        t = device_ms(kern)
        p = device_ms(plain, iters=5)
        q = args[0]
        b = q.shape[0]
        qh = q.reshape(b, s, kvh * grp, hd).transpose(1, 2)
        kg = ref.gather_rows(kp_ref, args[5], kv_len).transpose(1, 2)
        vg = ref.gather_rows(vp_ref, args[5], kv_len).transpose(1, 2)
        mask = ref.causal_mask(args[7], s, kg.shape[2])[:, None]
        lib = device_ms(lambda: F.scaled_dot_product_attention(
            qh, kg, vg, attn_mask=mask, enable_gqa=grp > 1))
        bound = _attn_bound(args, kv_len, bw, flops)
        log(f"{label} (window over {plan.splits} CTAs): max|diff|={err:.3g} "
            f"(one-ulp V bound {tol:.3g}, max|out| "
            f"{r.abs().max().item():.3g}) pools bit-equal (trash block "
            f"included), two calls bit-equal | "
            f"kernel {t:.4f} ms (plain {p:.4f}, bound {bound:.4f}, "
            f"{share(bound, t)} of bound) | sdpa {lib:.4f} ms, kernel / "
            f"sdpa {t / lib:.3f}")
        rows.append(dict(S=s, T=kv_len, KV=kvh, G=grp, hd=hd,
                         max_abs_err=err, ms=t, plain_ms=p, bound_ms=bound,
                         bound_by="bytes", library_ms=lib))
    return rows


def attention_row(rows: list[dict]) -> dict:
    """K3's row of the kernels line: the first case (decode, T = 81)."""
    return {k: v for k, v in rows[0].items()
            if k not in ("S", "T", "KV", "G", "hd")}


def check_trash_store(dev) -> None:
    """K3's store where rows collide: 8 rows, 6 of them inactive (all-
    trash tables) at depths that send them to the same trash cells, and
    one writing past its table width, at a decode step (S = 1) and a
    chunk (S = 16); the pools after the kernel equal the plain
    version's bit for bit, trash block included (the last row wins a
    cell on both), in two calls from the same pools."""
    import torch
    from repro_torch.kernels.paged_attention import ops
    b, kvh, grp, hd, bs, w = 8, 16, 1, 128, 16, 6
    g = torch.Generator(device=dev).manual_seed(11)
    for s in (1, 16):
        def rnd(*shape):
            return torch.randn(shape, generator=g, device=dev).to(
                torch.bfloat16)

        nb = 1 + 2 * w
        q = rnd(b, s, kvh, grp, hd)
        k_new, v_new = rnd(b, s, kvh, hd), rnd(b, s, kvh, hd)
        k_pool, v_pool = rnd(nb, bs, kvh, hd), rnd(nb, bs, kvh, hd)
        table = torch.zeros((b, w), dtype=torch.int32, device=dev)
        table[0] = torch.arange(1, w + 1)
        table[5] = torch.arange(w + 1, 2 * w + 1)
        # rows 1-4, 6 and 7 inactive, all at offset 3 of the trash block;
        # row 5 past its width from its fourth position on (S = 16)
        ci = torch.tensor([40, 3, 19, 35, 51, w * bs - 3 if s > 1 else 20,
                           67, 83], dtype=torch.int32, device=dev)
        args = (q, k_new, v_new, k_pool, v_pool, table, table.clone(), ci)
        kp_ref, vp_ref, _ = ops.paged_attention(*args, kv_len=w * bs,
                                                backend="torch")
        got = []
        for _ in range(2):
            kp, vp = k_pool.clone(), v_pool.clone()
            ops.paged_attention(*args[:3], kp, vp, *args[5:],
                                kv_len=w * bs, backend="cuda")
            got.append((kp, vp))
        torch.cuda.synchronize()
        equal = all(torch.equal(kp, kp_ref) and torch.equal(vp, vp_ref)
                    for kp, vp in got)
        last = torch.equal(kp_ref[0, 3], k_new[7, 0])
        log(f"paged_attention store, {b} rows, 6 inactive on one trash cell "
            f"(S={s}{', one row past its width' if s > 1 else ''}): pools "
            f"bit-equal to the plain version in two calls: {equal}; the "
            f"last row's value in the shared cell: {last}")
        if not (equal and last):
            raise AssertionError(f"K3's duplicate-trash store at S={s}")


GF2_SHAPES = [(128, 128), (200, 129), (64, 32), (48, 16), (512, 48),
              (1000, 129)]
GF2_ROWS = [1, 7, 130, 4096]
AES_BLOCKS = 1 << 24
GF2_PLAIN_CHUNK = 1 << 22        # rows per plain call in the big check


def _gf2_max_err(got, want) -> int:
    import torch
    return int((got.to(torch.int32) - want.to(torch.int32)).abs().max())


def _gf2_big_err(fn, plain, *inputs) -> int:
    """max |kernel - plain| of ``fn`` on full-size inputs, the plain
    version taken GF2_PLAIN_CHUNK rows at a time."""
    got = fn(*inputs)
    return max(_gf2_max_err(got[r0:r0 + GF2_PLAIN_CHUNK],
                            plain(inputs[0][r0:r0 + GF2_PLAIN_CHUNK],
                                  *inputs[1:]))
               for r0 in range(0, inputs[0].shape[0], GF2_PLAIN_CHUNK))


def check_gf2(dev, gpu_name: str) -> dict[str, dict]:
    """K4's two entries bit for bit against their plain versions at the
    card tests' shapes and at the AES shape (2^24 blocks, the cipher's
    ShiftRows∘MixColumns matrix), two calls bit-equal, and timed there
    beside their bounds, the plain versions and ``torch._int_mm`` +
    ``& 1`` (for the state-byte entry on the unpacked bits: no one
    PyTorch call computes it)."""
    import torch
    from repro_torch.apps import aes_app
    from repro_torch.kernels.gf2_mvm import ops, ref
    bw, _, int8_rate = peaks(gpu_name)
    g = torch.Generator(device=dev).manual_seed(4)
    mats = [torch.as_tensor(m, dtype=torch.int8, device=dev)
            for m in aes_app._linear_matrices()]

    def mvm(x, a):
        return ops.gf2_mvm(x, a, backend="cuda")

    def packed(s, a):
        return ops.gf2_mvm_packed(s, a, backend="cuda")

    def plain(x, a):
        return ops.gf2_mvm(x, a, backend="torch")

    def plain_packed(s, a):
        return ops.gf2_mvm_packed(s, a, backend="torch")

    for k, n in GF2_SHAPES:
        a = torch.randint(0, 2, (k, n), generator=g, device=dev,
                          dtype=torch.int8)
        for m in GF2_ROWS:
            x = torch.randint(-128, 128, (m, k), generator=g, device=dev,
                              dtype=torch.int8)
            if _gf2_max_err(mvm(x, a), plain(x, a)):
                raise AssertionError(f"gf2_mvm not bit-exact at M={m} "
                                     f"K={k} N={n}")
    # the state-byte entry: the three AES matrices and one of any int8
    # values (only each entry's low bit counts)
    any_a = torch.randint(-128, 128, (128, 128), generator=g, device=dev,
                          dtype=torch.int8)
    for a in mats + [any_a]:
        for m in GF2_ROWS:
            s = torch.randint(0, 256, (m, 16), generator=g, device=dev,
                              dtype=torch.uint8)
            if _gf2_max_err(packed(s, a), plain_packed(s, a)):
                raise AssertionError(f"gf2_mvm_packed not bit-exact at "
                                     f"M={m}")

    m, k, n = AES_BLOCKS, 128, 128
    a = mats[0]
    x = torch.randint(0, 2, (m, k), generator=g, device=dev,
                      dtype=torch.int8)
    err = _gf2_big_err(mvm, plain, x, a)
    if err or not deterministic(lambda: mvm(x, a)):
        raise AssertionError(f"gf2_mvm at the AES shape M={m}: max|diff| "
                             f"{err}, or two calls differ")
    t = event_ms(lambda: mvm(x, a))
    p = event_ms(lambda: plain(x, a), reps=2)
    acc = torch._int_mm(x, a)
    mm = event_ms(lambda: torch._int_mm(x, a))
    epi = event_ms(lambda: acc & 1)
    del acc
    bound = max((m * k + k * n + m * n) / bw, 2 * m * k * n / int8_rate) * 1e3
    log(f"gf2_mvm bit-exact at M in {GF2_ROWS} x (K, N) in {GF2_SHAPES} and "
        f"at M={m} K={k} N={n}, two calls bit-equal | kernel {t:.4f} ms "
        f"(plain {p:.4f}, bound {bound:.4f}, {share(bound, t)} of bound) | "
        f"_int_mm {mm:.4f} ms + & 1 {epi:.4f} ms")
    rows = {"gf2_mvm": dict(max_abs_err=err, ms=t, plain_ms=p,
                            bound_ms=bound, bound_by="bytes",
                            library_ms=mm + epi)}
    del x

    s = torch.randint(0, 256, (m, 16), generator=g, device=dev,
                      dtype=torch.uint8)
    err = _gf2_big_err(packed, plain_packed, s, a)
    if err or not deterministic(lambda: packed(s, a)):
        raise AssertionError(f"gf2_mvm_packed at M={m}: max|diff| {err}, "
                             f"or two calls differ")
    t = event_ms(lambda: packed(s, a))
    p = event_ms(lambda: plain_packed(s, a), reps=2)
    bits = ref.unpack_bits(s)
    mm = event_ms(lambda: torch._int_mm(bits, a) & 1)
    del bits
    bound = (2 * m * 16 + k * n) / bw * 1e3
    log(f"gf2_mvm_packed bit-exact at M in {GF2_ROWS} x the 3 AES matrices "
        f"and an int8 one, and at M={m}, two calls bit-equal | kernel "
        f"{t:.4f} ms (plain {p:.4f}, bound {bound:.4f}, {share(bound, t)} "
        f"of bound) | _int_mm + & 1 on the unpacked bits {mm:.4f} ms")
    rows["gf2_mvm_packed"] = dict(max_abs_err=err, ms=t, plain_ms=p,
                                  bound_ms=bound, bound_by="bytes",
                                  library_ms=None)
    return rows


# ---------------------------------------------------------------------------
# Phases 4-5b: serving the full-width model
# ---------------------------------------------------------------------------

SERVE_ARGS = ["--arch", "qwen2.5-3b", "--batch-slots", "4", "--requests",
              "6", "--min-prompt-len", "20", "--prompt-len", "64", "--gen",
              "16", "--kv-block-size", "16", "--chunked-prefill", "--seed",
              "0", "--device", "cuda"]
SERVE_MODES = ("pum", "int8", "bf16")
# the MVM kernel of each mode; bf16's projections are float matmuls
MVM_OF_MODE = {"pum": "bitslice_mvm_scaled", "int8": "bitslice_mvm",
               "bf16": None}


def per_pass(cfg) -> tuple[int, int]:
    """(MVM launches, attention layers) of one forward pass: q, k, v and
    o of an attention layer, the five projections of an mLSTM (qkv, i,
    f, output gate, out) or sLSTM (z, i, f, o, out) layer, and the MLP's
    (gate, up, down when gated): 7 a Qwen2.5-3B layer, 5 an xLSTM-350M
    one (it has no MLP)."""
    from repro_torch.models import transformer
    kinds = [transformer.layer_kinds(cfg, j) for j in range(cfg.num_layers)]
    mlp = 3 if cfg.activation == "silu" else 2
    attn = sum(mk == "attn" for mk, _ in kinds)
    mvm = sum((4 if mk == "attn" else 5) + mlp * (fk == "mlp")
              for mk, fk in kinds)
    return mvm, attn


def launch_gate(mode: str, cfg, steps: int, chunks: int,
                launches: dict, paged: bool = True) -> dict:
    """Every decode step and prefill chunk: the projections of every
    layer (``per_pass``) on the mode's MVM kernel and none on the other,
    and one K3 call an attention layer over the paged pool, none over
    contiguous windows."""
    mvm, attn = per_pass(cfg)
    want = {"bitslice_mvm_scaled": 0, "bitslice_mvm": 0,
            "paged_attention": attn * (steps + chunks) if paged else 0}
    if MVM_OF_MODE[mode]:
        want[MVM_OF_MODE[mode]] = mvm * (steps + chunks)
    got = {k: launches.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"{mode}: launches {got}, expected {want} for "
                             f"{steps} decode steps + {chunks} chunks")
    return got


def tokens_of(completions: dict) -> dict[int, list[int]]:
    return {rid: c.tokens for rid, c in sorted(completions.items())}


def timed_run(sched, requests) -> dict:
    """``sched.run(requests)``, with the launches, decode steps, chunks,
    decode ms/step, tokens/s and peak memory of exactly that run."""
    import torch
    from repro_torch.kernels import registry
    steps, chunks = sched.decode_steps, sched.prefill_chunks
    secs = sched.decode_seconds
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    registry.reset_launches()
    t0 = time.perf_counter()
    comps = sched.run(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = sched.decode_steps - steps
    return dict(tokens=tokens_of(comps), launches=dict(registry.LAUNCHES),
                steps=n, chunks=sched.prefill_chunks - chunks,
                decode_ms=1e3 * (sched.decode_seconds - secs) / max(1, n),
                tokens_per_s=sum(len(c.tokens) for c in comps.values())
                / wall, peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def serve_run(mode: str, smi: str) -> tuple[dict, dict]:
    """The main path: one run of the port's CLI, whose scheduler builds
    one CUDA graph for decode and one per chunk length as it goes.
    Returns the CLI's result and the launch counts of exactly that run
    (replays counted)."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.launch import serve
    torch.cuda.reset_peak_memory_stats()
    registry.reset_launches()
    res = serve.main(SERVE_ARGS + ["--pum-mode", mode])
    torch.cuda.synchronize()
    launches = dict(registry.LAUNCHES)
    sched = res["scheduler"]
    cfg = sched.cfg
    comps = res["completions"]
    vp = sched.params["embed"].shape[0]
    if len(comps) != 6 or any(
            len(c.tokens) != 16 or c.finish_reason != "length"
            or not all(0 <= t < vp for t in c.tokens)
            for c in comps.values()):
        raise AssertionError(f"{mode}: completions "
                             f"{[(c.rid, c.tokens) for c in comps.values()]}")
    steps, chunks = sched.decode_steps, sched.prefill_chunks
    got = launch_gate(mode, cfg, steps, chunks, launches)
    progs = sched.step_programs()
    built = [progs["decode"], *progs["chunk"].values()]
    if any(n != 1 for n in built) or res["graphs"] != len(built):
        raise AssertionError(f"{mode}: programs {progs}, {res['graphs']} "
                             f"graphs; want each built once, as a graph")
    log(f"serve {mode}: {cfg.name} {cfg.num_layers} layers d_model "
        f"{cfg.d_model}, 6 requests x 16 tokens, {steps} decode steps, "
        f"{chunks} prefill chunks; launches {got} (replays counted); "
        f"programs {progs}")
    log(f"serve {mode} graphs (first run, builds included): "
        f"decode_ms_per_step={res['decode_ms']:.3f} tokens_per_s="
        f"{res['tokens'] / res['wall_s']:.2f} graphs_captured="
        f"{res['graphs']} capture_s={res['build_s']:.2f} (warm-up "
        f"included) peak_mem_GB="
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} on {smi}")
    return res, launches


def chunk_and_step(sched, params, backend: str, toks=None):
    """One prefill chunk and one decode step of ``sched``'s model on
    ``params``, from a fresh pool, on ``backend``: their last logits
    [1, 2, V] in f32."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.models import lm
    cfg, dev = sched.cfg, sched.device
    bs, max_len = sched.block_size, sched.max_len
    w = sched.table_width
    if toks is None:
        g = torch.Generator(device="cpu").manual_seed(1)
        toks = torch.randint(0, cfg.vocab_size, (1, bs + 1), generator=g)
    toks = toks.to(dev, torch.int32)
    table = torch.arange(1, w + 1, dtype=torch.int32, device=dev)[None]
    states = lm.init_paged_state(cfg, 1, max_len, num_blocks=w,
                                 block_size=bs, device=dev)
    with torch.inference_mode(), registry.use_backend(backend):
        chunk, states = lm.forward(
            params, toks[:, :bs], cfg, states=states,
            cache_index=torch.zeros(1, dtype=torch.int32, device=dev),
            block_table=table, kv_len=max_len, last_only=True)
        step, states = lm.forward(
            params, toks[:, bs:], cfg, states=states,
            cache_index=torch.full((1,), bs, dtype=torch.int32, device=dev),
            block_table=table, kv_len=max_len, last_only=True)
    return torch.cat([chunk, step], dim=1).float()


def nudged(params):
    """``params`` with layer 0's attention input moved by one bf16 ulp
    on every other channel (its norm scale times 1 + ULP)."""
    import torch
    norm = dict(params["blocks"][0]["norm1"])
    nudge = torch.ones_like(norm["scale"])
    nudge[::2] += ULP
    norm["scale"] = norm["scale"] * nudge
    return dict(params, blocks=[dict(params["blocks"][0], norm1=norm),
                                *params["blocks"][1:]])


def backend_parity(sched) -> None:
    """One prefill chunk and one decode step of the served model, from
    the same fresh pool, on the ``cuda`` and the ``torch`` backends, and
    on ``cuda`` once more with layer 0's attention input moved by one
    bf16 ulp on every other channel: that run's change is the bound."""
    import torch
    cfg, params = sched.cfg, sched.params
    a = chunk_and_step(sched, params, "cuda")
    b = chunk_and_step(sched, params, "torch")
    c = chunk_and_step(sched, nudged(params), "cuda")
    if not all(bool(torch.isfinite(t).all()) for t in (a, b, c)):
        raise AssertionError("non-finite logits")
    err = (a - b).abs().max().item()
    bound = (c - a).abs().max().item()
    same = bool((a.argmax(-1) == b.argmax(-1)).all())
    log(f"backend parity {cfg.pum.mode}: chunk + decode logits "
        f"max|cuda - torch| = {err:.4g}, bound (one-ulp nudge of layer 0) "
        f"= {bound:.4g}, max|logit| = {b.abs().max().item():.4g}, greedy "
        f"tokens equal on every row: {same}")
    if bound == 0.0:
        raise AssertionError("the one-ulp nudge did not reach the logits")
    if err > bound or not same:
        raise AssertionError(f"backend parity failed: {err} > {bound} or "
                             f"greedy differs")


def kernel_times(run):
    """``run()`` under ``torch.profiler``: (wall s, device us by kernel
    name).  The profiler slows the host, so its wall time is not an
    unprofiled run's; the kernel times are the card's."""
    import collections
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: collections.Counter[str] = collections.Counter()
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            by_name[evt.name] += evt.time_range.elapsed_us()
    return wall, by_name


def top_kernels(by_name, n: int = 6) -> str:
    return ", ".join(
        f"{name.replace('void ', '').replace('(anonymous namespace)::', '')[:40]}"
        f" {us / 1e3:.1f} ms" for name, us in by_name.most_common(n))


def profiled(run) -> tuple[float, float, str] | None:
    """``run()`` under ``torch.profiler``: (wall s, s the card spent in
    kernels, the top kernels by time), or None when the profiler saw no
    device time."""
    wall, by_name = kernel_times(run)
    if not by_name:
        return None
    return wall, sum(by_name.values()) / 1e6, top_kernels(by_name)


def like(sched, cuda_graphs: bool, kernel_backend=None):
    """A fresh scheduler of ``sched``'s geometry on its params."""
    from repro_torch.serve import ContinuousBatchingScheduler
    return ContinuousBatchingScheduler(
        sched.cfg, sched.params, num_slots=sched.num_slots,
        max_len=sched.max_len, kv_block_size=sched.block_size,
        num_kv_blocks=sched.num_kv_blocks,
        chunked_prefill=sched.chunked_prefill, device=sched.device,
        cuda_graphs=cuda_graphs, kernel_backend=kernel_backend)


def graph_vs_eager(sched) -> None:
    """One prefill chunk and one decode step of the served model, each
    from a fresh pool, with ``cuda_graphs`` on and off: the same kernels
    on the same inputs, so the logits must be equal bit for bit (the
    chunk's, and the decoding row's of the step) and so the tokens."""
    import torch
    from repro_torch.serve import Request
    bs = sched.block_size
    g = torch.Generator().manual_seed(2)
    prompt = torch.randint(0, sched.cfg.vocab_size, (bs,),
                           generator=g).tolist()
    got = {}
    for graphs in (True, False):
        s = like(sched, graphs)
        s.start_request(Request(prompt, max_tokens=2, rid=0))
        res = s.tick(0)              # the prompt's one chunk, then a step
        logits = s.last_logits()
        got[graphs] = ([t for _, _, t in res.events], logits[bs].clone(),
                       logits["decode"][0].clone())
        del s
    (tok_g, chunk_g, step_g), (tok_e, chunk_e, step_e) = got[True], got[False]
    equal = torch.equal(chunk_g, chunk_e) and torch.equal(step_g, step_e)
    err = max((chunk_g - chunk_e).abs().max().item(),
              (step_g - step_e).abs().max().item())
    log(f"graph vs eager {sched.cfg.pum.mode}: chunk of {bs} + one decode "
        f"step logits bit-equal: {equal} (max|diff| {err:.3g}), tokens "
        f"{tok_g} / {tok_e}")
    if not equal or tok_g != tok_e or len(tok_g) != 2:
        raise AssertionError("graph and eager steps differ")


def step_device_ms(sched, temps=None) -> float:
    """Device time of one replay of the decode graph, between CUDA
    events, every slot active at a depth of 60 tokens (the trace's
    middle) through its own blocks or in its own window (the scheduler
    is idle after the run), at temperatures ``temps`` (default: all
    greedy; the graph runs the sampler either way)."""
    import numpy as np
    prog = sched.program("decode")
    b, w = sched.num_slots, sched.table_width
    table = [np.arange(1, b * w + 1, dtype=np.int32).reshape(b, w)] \
        if sched.paged else []
    ones = np.ones(b, np.int32)
    temps = np.zeros(b, np.float32) if temps is None \
        else np.asarray(temps, np.float32)
    keys = np.stack([np.zeros(b, np.int32), np.arange(b, dtype=np.int32)],
                    axis=1)
    prog.stage(np.zeros((b, 1), np.int32), 60 * ones, keys, ones,
               temps.view(np.int32), -ones, ones, (1 << 20) * ones, *table)
    return event_ms(prog.launch, reps=20)


def head_share(sched, step_ms: float, smi: str) -> None:
    """The f32 lm head alone (``lm.forward``'s last matmul) at the
    decode step's B, timed with CUDA events, as a share of the step."""
    import torch
    cfg, params, dev = sched.cfg, sched.params, sched.device
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    g = torch.Generator(device=dev).manual_seed(3)
    h = torch.randn((sched.num_slots, 1, cfg.d_model), generator=g,
                    device=dev)
    ms = device_ms(lambda: torch.matmul(h, head.to(torch.float32)))
    log(f"lm head {cfg.pum.mode}: f32 [{sched.num_slots}, {cfg.d_model}] x "
        f"{list(head.shape)} {ms:.4f} ms = {100 * ms / step_ms:.1f} % of one "
        f"decode step's device time {step_ms:.4f} ms (graph replay) on {smi}")


def device_busy(sched, label: str, smi: str) -> None:
    """A short burst (4 requests of 20..32 prompt tokens, 6 tokens each:
    2 prefill chunks a request, then a full slot pool decoding) under
    the profiler: the share of the wall time the card spends in kernels,
    and the kernels that take it.  The burst runs once unprofiled first,
    so any graph it needs is built outside the window.  The window is
    short because reading the trace back costs far more than recording
    it."""
    from repro_torch.serve import synthetic_workload
    requests = synthetic_workload(4, sched.cfg.vocab_size, min_prompt=20,
                                  max_prompt=32, max_new=6, seed=1)
    sched.run(requests)
    steps, chunks = sched.decode_steps, sched.prefill_chunks
    res = profiled(lambda: sched.run(requests))
    if res is None:
        log(f"profile {label}: the profiler saw no device time (not "
            f"measured) on {smi}")
        return
    wall, busy, top = res
    log(f"profile {label}: {sched.decode_steps - steps} decode steps + "
        f"{sched.prefill_chunks - chunks} prefill chunks, wall "
        f"{wall:.3f} s under the profiler, kernels {busy:.3f} s "
        f"({100 * busy / wall:.1f} % busy) on {smi}; top: {top}")


def serve_phases(smi: str) -> tuple[dict[str, int], dict[str, dict]]:
    """Phases 4-5b; returns each kernel's launches on the main path
    (each mode's first run), and by mode the greedy trace's tokens and
    its decode ms/step, graphs and eager (phase 8 compares with them)."""
    import gc
    import torch
    launches: dict[str, int] = {}
    greedy: dict[str, dict] = {}
    for mode in SERVE_MODES:
        res, counts = serve_run(mode, smi)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        sched = res["scheduler"]
        graph_vs_eager(sched)
        first = tokens_of(res["completions"])
        # the same trace again: nothing new to build, the same tokens
        progs = sched.step_programs()
        steady = timed_run(sched, res["requests"])
        if sched.step_programs() != progs or steady["tokens"] != first:
            raise AssertionError(f"{mode}: the second run built "
                                 f"{sched.step_programs()} (had {progs}) or "
                                 f"changed its tokens")
        launch_gate(mode, sched.cfg, steady["steps"],
                    steady["chunks"], steady["launches"])
        eager_sched = like(sched, cuda_graphs=False)
        eager = timed_run(eager_sched, res["requests"])
        if eager["tokens"] != first or eager["launches"] != steady["launches"]:
            raise AssertionError(
                f"{mode}: eager run differs from the graph run: tokens equal "
                f"{eager['tokens'] == first}, launches {eager['launches']} "
                f"against {steady['launches']}")
        log(f"serve {mode} graphs vs eager, the same trace (completions "
            f"equal token for token, launches equal): decode_ms_per_step "
            f"{steady['decode_ms']:.3f} / {eager['decode_ms']:.3f}, "
            f"tokens_per_s {steady['tokens_per_s']:.2f} / "
            f"{eager['tokens_per_s']:.2f}, peak_mem_GB "
            f"{steady['peak_gb']:.2f} / {eager['peak_gb']:.2f} on {smi}")
        greedy[mode] = dict(tokens=first, graph_ms=steady["decode_ms"],
                            eager_ms=eager["decode_ms"])
        backend_parity(sched)
        step_ms = step_device_ms(sched)
        busy = 100 * step_ms / steady["decode_ms"]
        log(f"serve {mode} decode step: device {step_ms:.4f} ms a graph "
            f"replay, host {steady['decode_ms']:.3f} ms a step in the "
            f"graph run: the card busy {busy:.1f} % of a decode step (no "
            f"profiler) on {smi}")
        head_share(sched, step_ms, smi)
        device_busy(sched, f"{mode} graphs", smi)
        device_busy(eager_sched, f"{mode} eager", smi)
        greedy[mode]["replay_ms"] = step_ms
        del res, sched, eager_sched
        gc.collect()
        torch.cuda.empty_cache()
    return launches, greedy


# ---------------------------------------------------------------------------
# Phase 6: the AES path
# ---------------------------------------------------------------------------

FIPS197 = [  # (key, plaintext, ciphertext): Appendix C.1-C.3 and B
    ("000102030405060708090a0b0c0d0e0f", "00112233445566778899aabbccddeeff",
     "69c4e0d86a7b0430d8cdb78070b4c55a"),
    ("000102030405060708090a0b0c0d0e0f1011121314151617",
     "00112233445566778899aabbccddeeff", "dda97ca4864cdfe06eaf70a0ec0d7191"),
    ("000102030405060708090a0b0c0d0e0f101112131415161718191a1b1c1d1e1f",
     "00112233445566778899aabbccddeeff", "8ea2b7ca516745bfeafc49904b496089"),
    ("2b7e151628aed2a6abf7158809cf4f3c", "3243f6a8885a308d313198a2e0370734",
     "3925841d02dc09fbdc118597196a0b32"),
]


def check_fips197(dev) -> None:
    """The FIPS-197 vectors through the numpy oracle, the bulk cipher
    (K4's state-byte entry and the plain composition) and the DCE path,
    on the card."""
    import numpy as np
    from repro_torch.apps import aes_app

    def h(s):
        return np.frombuffer(bytes.fromhex(s), np.uint8).copy()

    for key, pt, ct in FIPS197:
        key, pt, ct = h(key), h(pt), h(ct)
        got = {"oracle": aes_app.aes_encrypt_np(pt, key),
               "dce": aes_app.aes_encrypt_dce(pt[None], key, device=dev)[0]}
        for use_kernel in (True, False):
            c = aes_app.aes_encrypt(pt[None], key, use_kernel=use_kernel,
                                    device=dev)
            back = aes_app.aes_decrypt(c, key, use_kernel=use_kernel,
                                       device=dev)
            got[f"bulk kernel={use_kernel}"] = c[0].cpu().numpy()
            if not np.array_equal(back[0].cpu().numpy(), pt):
                raise AssertionError(f"FIPS-197 decrypt failed, kernel="
                                     f"{use_kernel}, key {key.tobytes().hex()}")
        bad = [k for k, v in got.items() if not np.array_equal(v, ct)]
        if bad:
            raise AssertionError(f"FIPS-197 vector of key "
                                 f"{key.tobytes().hex()} failed on {bad}")
    log("aes: FIPS-197 Appendix B and C.1-C.3 equal through the oracle, "
        "the bulk cipher (K4's state-byte entry and plain) and the DCE "
        "path")


def aes_phase(dev, smi: str) -> dict[str, int]:
    """Phase 6; returns each kernel's launches on the AES path."""
    import gc
    import torch
    from repro_torch.apps import aes_app
    from repro_torch.kernels import registry
    from repro_torch.launch import aes
    launches: dict[str, int] = {}
    for key_bytes in (16, 24, 32):
        registry.reset_launches()
        res = aes.main(["--blocks", str(AES_BLOCKS), "--key-bytes",
                        str(key_bytes), "--seed", "0", "--device",
                        str(dev)])
        torch.cuda.synchronize()
        counts = dict(registry.LAUNCHES)
        nr = res["rounds"]
        # warm-up and timed call each: encrypt (Nr) and decrypt (Nr - 1)
        # on the state-byte entry, and nothing else
        want = {"gf2_mvm_packed": 2 * (2 * nr - 1)}
        got = (res["encrypt_launches"], res["decrypt_launches"])
        if got != (nr, nr - 1) or counts != want:
            raise AssertionError(
                f"AES-{8 * key_bytes}: K4 launches encrypt / decrypt "
                f"{got} (want {nr}, {nr - 1}); run {counts}, want {want}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        gates = res["gates"]
        log(f"aes AES-{8 * key_bytes}: {AES_BLOCKS} blocks, "
            f"encrypt_MB_per_s={res['encrypt_mb_per_s']:.1f} "
            f"decrypt_MB_per_s={res['decrypt_mb_per_s']:.1f} on {smi}; "
            f"oracle equal on {res['oracle_blocks']} strided blocks, "
            f"round trip equal on every block, K4 launches {nr} / {nr - 1} "
            f"per encrypt / decrypt; DCE path on "
            f"{res['dce_blocks']} blocks equal, {gates.nor} NOR + "
            f"{gates.copy} copy primitives")
        pt, key = res["pt"], res["key"]
        del res
        prof = profiled(lambda: aes_app.aes_encrypt(pt, key, use_kernel=True,
                                                    device=dev))
        if prof is None:
            log(f"profile aes-{8 * key_bytes}: the profiler saw no device "
                f"time (not measured)")
        else:
            wall, busy, top = prof
            log(f"profile aes-{8 * key_bytes}: one bulk encryption, wall "
                f"{wall:.3f} s under the profiler, kernels {busy:.3f} s "
                f"({100 * busy / wall:.1f} % busy); top: {top}")
        if key_bytes == 16:
            aes_round_split(pt, key, dev)
        del pt
        gc.collect()
        torch.cuda.empty_cache()
    check_fips197(dev)
    return launches


def aes_round_split(pt, key, dev) -> None:
    """Device time of each op of one encrypt round (round 1) at the run's
    block count, each timed alone between CUDA events."""
    import torch
    from repro_torch.apps import aes_app
    from repro_torch.kernels.gf2_mvm import ops
    rks, (m_lin, _, _) = aes_app._consts(key, dev)
    sbox = torch.as_tensor(aes_app.SBOX, device=dev)
    s = pt ^ rks[0]
    idx = s.long()
    sub = sbox[idx]
    lin = ops.gf2_mvm_packed(sub, m_lin)
    parts = {"index s.long()": event_ms(lambda: s.long()),
             "S-box gather sbox[idx]": event_ms(lambda: sbox[idx]),
             "K4 gf2_mvm_packed": event_ms(
                 lambda: ops.gf2_mvm_packed(sub, m_lin)),
             "round-key XOR": event_ms(lambda: lin ^ rks[1])}
    total = sum(parts.values())
    log(f"aes round split at {pt.shape[0]} blocks (round 1, each op timed "
        f"alone): " + ", ".join(f"{k} {v:.4f} ms ({100 * v / total:.1f} %)"
                                for k, v in parts.items())
        + f"; sum {total:.4f} ms")


# ---------------------------------------------------------------------------
# Phase 7: the CNN path (ResNet-20 on CIFAR-10 shapes, paper §5.1, §7.5)
# ---------------------------------------------------------------------------

CNN_IMAGES = 1024
CNN_WIDTH = 16
SWEEP_IMAGES = 256
SIGMAS = (0.0, 0.02, 0.05, 0.1, 0.3)
# the JAX package's bound on agreement without noise (tests/test_apps.py)
CLEAN_AGREEMENT = 0.75
# K2's launches in one ResNet-20 forward: (layer, rows per image, K, N,
# launches); the stride-2 conv im2cols at full size, then subsamples
CNN_LAYERS = [("stem", 1024, 27, 16, 1),
              ("stage-0 conv", 1024, 144, 16, 6),
              ("s1b0.conv1", 256, 144, 32, 1),
              ("stage-1 conv", 256, 288, 32, 5),
              ("s1 projection", 256, 16, 32, 1),
              ("s2b0.conv1", 64, 288, 64, 1),
              ("stage-2 conv", 64, 576, 64, 5),
              ("s2 projection", 64, 32, 64, 1),
              ("classifier", 1, 64, 10, 1)]
CNN_LAUNCHES = sum(layer[-1] for layer in CNN_LAYERS)     # 22


def check_cnn_mvm(dev, gpu_name: str) -> list[dict]:
    """K2's unpacked entry (planes sliced per call, N padded to 16) at
    each ResNet-20 layer shape over CNN_IMAGES images, bit for bit
    against its plain version, two calls bit-equal, timed beside its
    byte bound and ``torch._int_mm`` on the recombined weight (K and N
    padded to multiples of 8, as it requires; the padding not timed)."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.kernels.bitslice_mvm import ops
    bw, _, int8_rate = peaks(gpu_name)
    g = torch.Generator(device=dev).manual_seed(7)
    props = registry.device_props(dev.index)
    rows = []
    for name, per_image, k, n, _ in CNN_LAYERS:
        m = per_image * CNN_IMAGES
        x = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                          dtype=torch.int32).to(torch.int8)
        wq = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                           dtype=torch.int32)

        def kern():
            return ops.bitslice_mvm(x, wq, backend="cuda")

        def plain():
            return ops.bitslice_mvm(x, wq, backend="torch")

        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not torch.equal(got, want) or not deterministic(kern):
            raise AssertionError(f"bitslice_mvm (unpacked) at {name} M={m} "
                                 f"K={k} N={n}: max|diff| {err}, or two "
                                 f"calls differ")
        del got, want
        plan = ops.mvm_plan(m, k, -(-n // ops.VEC) * ops.VEC, 4, props)
        t = device_ms(kern, iters=10)
        p = device_ms(plain, iters=3, reps=2)
        k8, n8 = -(-k // 8) * 8, -(-n // 8) * 8
        xl = torch.zeros((max(m, 17), k8), dtype=torch.int8, device=dev)
        xl[:m, :k] = x
        wl = torch.zeros((k8, n8), dtype=torch.int8, device=dev)
        wl[:k, :n] = wq.to(torch.int8)
        lib = device_ms(lambda: torch._int_mm(xl, wl), iters=10)
        s = 4                        # planes of 8-bit weights, 2-bit cells
        nbytes = m * k + 4 * s * k * n + 4 * m * n
        by_bytes, by_ops = nbytes / bw * 1e3, mvm_ops(m, k, n) / int8_rate \
            * 1e3
        bound = max(by_bytes, by_ops)
        log(f"cnn mvm {name} M={m} K={k} N={n} S={s} (grid z "
            f"{plan.grid_rows} CTAs over {plan.row_tiles} row tiles of "
            f"{plan.mt}): exact, two calls bit-equal | kernel {t:.4f} ms "
            f"(plain {p:.4f}, bound {bound:.4f}, {share(bound, t)} of "
            f"bound) | _int_mm {lib:.4f} ms")
        rows.append(dict(shape=f"{name} M={m} K={k} N={n} S={s}",
                         max_abs_err=err, ms=t, plain_ms=p, bound_ms=bound,
                         bound_by="bytes" if by_bytes >= by_ops
                         else "operations", library_ms=lib))
        del x, xl
    return rows


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def cnn_phase(dev, gpu_name: str, smi: str) -> tuple[dict[str, int],
                                                      list[dict]]:
    """Phase 7: ResNet-20 at its published width on the card.  Returns
    K2's launches on the path (the gated forward) and its rows at the
    layer shapes."""
    import gc
    import torch
    from repro_torch.apps import resnet_app
    from repro_torch.kernels import registry
    from repro_torch.models import resnet
    rows = check_cnn_mvm(dev, gpu_name)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    log(f"cnn: torch.backends.cuda.matmul.allow_tf32={tf32} (the f32 "
        f"reference runs in full f32)")
    if tf32:
        raise AssertionError("f32 matmuls would run on TF32")
    gen = torch.Generator(dev).manual_seed(0)
    params = resnet.resnet20_init(gen, width=CNN_WIDTH, device=dev)
    x, _ = resnet_app.synthetic_images(gen, CNN_IMAGES, device=dev)
    n_weights = sum(t.numel() for t in _leaves(params) if t.ndim == 2)
    pum = resnet_app.pum_config(0.0)

    def forward(cfg):
        with torch.no_grad():
            return resnet.resnet20_apply(params, x, cfg)

    # the main path: counts set to 0 just before, read just after
    registry.reset_launches()
    logits = forward(pum)
    torch.cuda.synchronize()
    launches = dict(registry.LAUNCHES)
    if launches != {"bitslice_mvm": CNN_LAUNCHES}:
        raise AssertionError(f"cnn: launches {launches}, want "
                             f"{CNN_LAUNCHES} of bitslice_mvm and no other")
    with registry.use_backend("torch"):
        plain = forward(pum)
    again = forward(pum)
    finite = bool(torch.isfinite(logits).all())
    same_plain, same_again = torch.equal(logits, plain), \
        torch.equal(logits, again)
    log(f"cnn: ResNet-20 width {CNN_WIDTH} ({n_weights} weights), "
        f"{CNN_IMAGES} images, pum: {launches['bitslice_mvm']} bitslice_mvm "
        f"launches a forward, none of bitslice_mvm_scaled; logits "
        f"{tuple(logits.shape)} bit-equal to the torch backend's: "
        f"{same_plain} (max|diff| "
        f"{(logits - plain).abs().max().item():.3g}), two runs bit-equal: "
        f"{same_again}, finite: {finite}")
    if not (finite and same_plain and same_again
            and logits.shape == (CNN_IMAGES, 10)):
        raise AssertionError("cnn: pum forward failed its gates")
    del plain, again
    floats = forward(resnet_app.FLOAT)
    agree = float((logits.argmax(-1) == floats.argmax(-1)).float().mean())
    rel = ((logits - floats).abs().max() / floats.abs().max()).item()
    log(f"cnn: pum vs float (f32 torch.matmul) on {CNN_IMAGES} images: "
        f"argmax agreement {agree:.4f}, max|diff| / max|float logit| "
        f"{rel:.4f}")
    del floats
    ms = {mode: event_ms(lambda: forward(cfg), reps=5)
          for mode, cfg in (("pum", pum), ("bf16", resnet_app.FLOAT))}
    log("cnn: " + ", ".join(f"{mode} {CNN_IMAGES / ms[mode] * 1e3:.1f} "
                            f"images/s ({ms[mode]:.3f} ms a forward of "
                            f"{CNN_IMAGES})" for mode in ms)
        + f" on {smi}")
    wall, by_name = kernel_times(lambda: forward(pum))
    if by_name:
        total = sum(by_name.values()) / 1e3
        k2 = sum(us for name, us in by_name.items()
                 if "bitslice_mvm_kernel" in name) / 1e3
        log(f"cnn profile pum forward: device {total:.3f} ms, K2 "
            f"{k2:.3f} ms ({100 * k2 / total:.1f} %) over "
            f"{CNN_LAUNCHES} launches, wall {wall * 1e3:.3f} ms under the "
            f"profiler ({100 * total / 1e3 / wall:.1f} % busy); top 5: "
            f"{top_kernels(by_name, 5)}")
    else:
        log("cnn profile: the profiler saw no device time (not measured)")
    del logits
    gc.collect()
    torch.cuda.empty_cache()

    # the §7.5 agreement sweep, as benchmarks/noise_accuracy.py runs it
    xs = x[:SWEEP_IMAGES]
    agreement = {}
    for sigma in SIGMAS:
        agreement[sigma] = resnet_app.agreement(
            params, xs, sigma, torch.Generator(dev).manual_seed(1))
    noisy_cfg = resnet_app.pum_config(0.05)

    def noisy(seed):
        with torch.no_grad():
            return resnet.resnet20_apply(
                params, xs, noisy_cfg,
                generator=torch.Generator(dev).manual_seed(seed))

    t0 = time.perf_counter()
    a = noisy(1)
    torch.cuda.synchronize()
    noisy_s = time.perf_counter() - t0
    b, c = noisy(1), noisy(2)
    with torch.no_grad():
        clean = resnet.resnet20_apply(params, xs, pum)
    drawn, repeat, reseeded = not torch.equal(a, clean), torch.equal(a, b), \
        not torch.equal(a, c)
    log(f"cnn noise sweep (width {CNN_WIDTH}, {SWEEP_IMAGES} images, SAR "
        f"ADC 10 bits): agreement with the float model "
        + ", ".join(f"sigma={s}: {v:.4f}" for s, v in agreement.items())
        + f"; noise on (sigma 0.05) differs from off: {drawn}, the same "
        f"seed twice bit-equal: {repeat}, another seed differs: {reseeded}; "
        f"one noisy forward {noisy_s:.2f} s (ACE simulation)")
    if not (agreement[0.0] >= CLEAN_AGREEMENT
            and agreement[0.3] <= agreement[0.0] and drawn and repeat
            and reseeded):
        raise AssertionError("cnn: the noise sweep failed its gates")
    return {"bitslice_mvm": launches["bitslice_mvm"]}, rows


# ---------------------------------------------------------------------------
# Phase 8: sampled serving (temperature > 0 from threefry keys)
# ---------------------------------------------------------------------------

# phase 4's six requests (the same prompts: the trace's temperatures and
# seeds are drawn after its prompts) at these temperatures, a seed each
SAMPLED_TEMPS = (0.0, 0.7, 1.0, 0.0, 0.7, 1.0)
SAMPLED_SEEDS = (1001, 1002, 1003, 1004, 1005, 1006)
# Threefry-2x32 known answers: (key, count) -> output, 20 rounds
THREEFRY_KAT = [((0x13198a2e, 0x03707344, 0x243f6a88, 0x85a308d3),
                 (0xc4923a9c, 0x483df7a0)),
                ((0, 0, 0, 0), (0x6b200159, 0x99ba4efe))]
# CUDA's logf and the CPU's log may differ by an ulp: the card's Gumbel
# values lie within GUMBEL_ULPS ulps of max(|g|, 1) of the CPU's, and a
# draw may differ from the CPU's only where the CPU's top-2 score margin
# is within NEAR_TIE, far above that difference (2 ulps of a value
# below 17 are under 4e-6)
GUMBEL_ULPS = 2
NEAR_TIE = 1e-5
# a decode step's logits: 4 slots x Qwen2.5-3B's padded vocabulary
SAMPLER_ROWS, SAMPLER_VOCAB = 4, 152064
CATEGORICAL_ROWS = 64
# the distribution check: 2^20 rows, a key each, one 16-way categorical
# at t = 0.7; every class's frequency within 5 sigma of softmax(l / t)
DIST_ROWS, DIST_T, DIST_SIGMAS = 1 << 20, 0.7, 5.0
DIST_LOGITS = [0.0, 1.0, -1.0, 2.0, 0.5, -0.5, 1.5, -2.0, 0.25, -0.25,
               0.75, -0.75, 1.25, -1.25, 0.1, -3.0]
# greedy decode ms/step, graphs, of the same trace recorded before the
# sampler was part of the decode graph (PERF.md §6: an H100 80GB HBM3 at
# 700 W)
PRE_SAMPLER_GREEDY_MS = {"pum": 17.046, "int8": 17.776, "bf16": 14.369}


def _u32(t) -> list[int]:
    return t.cpu().numpy().view("uint32").tolist()


def check_sampler(dev, smi: str) -> float:
    """The sampler (``serve/prng.py`` and ``sample_token``) on the card
    against its own CPU result and against its definition.  Returns its
    device ms at a decode step's shapes."""
    import numpy as np
    import torch
    from repro_torch.serve import prng
    from repro_torch.serve.engine import sample_token
    for words, want in THREEFRY_KAT:
        got = prng.threefry2x32(*(
            torch.from_numpy(np.array([w], np.uint32).view(np.int32)).to(dev)
            for w in words))
        if [_u32(t)[0] for t in got] != list(want):
            raise AssertionError(f"threefry2x32{words}: "
                                 f"{[hex(_u32(t)[0]) for t in got]}")
    b, v = SAMPLER_ROWS, SAMPLER_VOCAB
    one = prng.prng_key(7)
    rows = torch.stack([prng.prng_key(s) for s in range(b)])
    worst = 0.0
    for key, shape in ((one, (b, v)), (rows, (v,))):
        for fn in (prng.random_bits, prng.uniform):
            if not torch.equal(fn(key.to(dev), shape).cpu(), fn(key, shape)):
                raise AssertionError(f"{fn.__name__} on the card differs "
                                     f"from the CPU's")
        got = prng.gumbel(key.to(dev), shape).cpu().numpy()
        want = prng.gumbel(key, shape).numpy()
        ulps = np.abs(got - want) / np.spacing(
            np.maximum(np.abs(want), 1).astype(np.float32))
        worst = max(worst, float(ulps.max()))
    if worst > GUMBEL_ULPS:
        raise AssertionError(f"gumbel {worst} ulps from the CPU's")
    g = torch.Generator().manual_seed(8)
    logits = 3 * torch.randn((CATEGORICAL_ROWS, v), generator=g)
    near_ties = draws = 0
    for key in (prng.prng_key(9), torch.stack(
            [prng.prng_key(s) for s in range(CATEGORICAL_ROWS)])):
        got = prng.categorical(key.to(dev), logits.to(dev)).cpu()
        want = prng.categorical(key, logits)
        shape = logits.shape[key.ndim - 1:]
        top2 = torch.topk(prng.gumbel(key, shape) + logits, 2).values
        near = (top2[:, 0] - top2[:, 1]) <= NEAR_TIE
        if not torch.equal(got[~near], want[~near]):
            raise AssertionError("categorical draws on the card differ from "
                                 "the CPU's away from a near-tie")
        near_ties += int(near.sum())
        draws += len(got)
    log(f"sampler: threefry2x32 known answers equal on the card; random "
        f"bits and uniforms over [{b}, {v}] (one key) and {b} x [{v}] (a "
        f"key a row) bit-equal to the CPU's; gumbel within {worst:.0f} "
        f"ulps of max(|g|, 1) of the CPU's (bound {GUMBEL_ULPS}); "
        f"categorical draws equal on {draws - near_ties} of {draws}, "
        f"{near_ties} near-ties (CPU top-2 margin <= {NEAR_TIE}) not "
        f"compared")
    # the distribution: 2^20 rows, a key each, one categorical at t = 0.7
    n = DIST_ROWS
    keys = prng.fold_in(prng.prng_key(2024, dev).expand(n, 2),
                        torch.arange(n, dtype=torch.int32, device=dev))
    dist = torch.tensor(DIST_LOGITS, device=dev).expand(n, 1, -1)
    tok = sample_token(dist, keys, torch.full((n,), DIST_T, device=dev))
    freq = torch.bincount(tok[:, 0].long(), minlength=len(DIST_LOGITS))
    freq = freq.cpu().numpy() / n
    scaled = np.array(DIST_LOGITS, np.float64) / np.float32(DIST_T)
    p = np.exp(scaled - scaled.max())
    p /= p.sum()
    z = (freq - p) / np.sqrt(p * (1 - p) / n)
    log(f"sampler distribution: {n} rows at t = {DIST_T}, 16 classes: "
        f"max |freq - softmax(l / t)| = {np.abs(freq - p).max():.3g}, "
        f"max |z| = {np.abs(z).max():.2f} (bound {DIST_SIGMAS:.0f} sigma)")
    if np.abs(z).max() > DIST_SIGMAS:
        raise AssertionError(f"sampled frequencies {freq} against {p}")
    # the sampler alone at a decode step's shapes: fold the keys, draw
    g = torch.Generator(device=dev).manual_seed(9)
    step_logits = torch.randn((b, 1, v), generator=g, device=dev)
    step_keys = rows.to(dev)
    gen = torch.arange(1, b + 1, dtype=torch.int32, device=dev)
    temps = torch.tensor([0.0, 0.7, 1.0, 0.7], device=dev)
    ms = device_ms(lambda: sample_token(
        step_logits, prng.fold_in(step_keys, gen - 1), temps))
    log(f"sampler at a decode step's shapes ([{b}, 1, {v}] f32 logits, "
        f"{b} keys folded): {ms:.4f} ms of device time on {smi}")
    return ms


def sampled_run(mode: str, greedy: dict, sampler_ms: float,
                smi: str) -> dict[str, int]:
    """Phase 8 in one mode: the CLI at ``--temperature 0.7`` (the main
    path; its launches are returned), then, on its scheduler, phase 4's
    requests at ``SAMPLED_TEMPS``, each seeded, with every gate."""
    import dataclasses
    import torch
    from repro_torch.kernels import registry
    from repro_torch.launch import serve
    from repro_torch.serve import oracle_completion
    registry.reset_launches()
    res = serve.main(SERVE_ARGS + ["--pum-mode", mode, "--temperature",
                                   "0.7"])
    torch.cuda.synchronize()
    launches = dict(registry.LAUNCHES)
    sched = res["scheduler"]
    cfg = sched.cfg
    comps = res["completions"]
    vp = sched.params["embed"].shape[0]
    if len(comps) != 6 or any(
            len(c.tokens) != 16 or not all(0 <= t < vp for t in c.tokens)
            for c in comps.values()):
        raise AssertionError(f"sampled {mode}: CLI completions "
                             f"{[(c.rid, c.tokens) for c in comps.values()]}")
    launch_gate(mode, cfg, sched.decode_steps,
                sched.prefill_chunks, launches)
    progs = sched.step_programs()
    if progs["decode"] != 1 or any(n != 1 for n in progs["chunk"].values()):
        raise AssertionError(f"sampled {mode}: programs {progs}")
    reqs = [dataclasses.replace(r, temperature=t, seed=s) for r, t, s in
            zip(res["requests"], SAMPLED_TEMPS, SAMPLED_SEEDS)]
    first = timed_run(sched, reqs)
    again = timed_run(sched, reqs)
    reseeded = timed_run(sched, [dataclasses.replace(r, seed=r.seed + 1)
                                 for r in reqs])
    eager = timed_run(like(sched, cuda_graphs=False), reqs)
    tokens = first["tokens"]
    t0 = time.perf_counter()
    # each request alone through the same kernels: co-tenants never move
    # a row's numerics, so each comes back as in the mixed batch
    alone = {r.rid: tokens_of(sched.run([r]))[r.rid] for r in reqs}
    # the port's solo oracle, generate_loop, keeps a contiguous cache and
    # attends through the plain composition, never K3, whose f32 sums
    # run in another order (backend parity): it equals the scheduler bit
    # for bit where both run the same arithmetic, the torch backend
    plain = like(sched, cuda_graphs=True, kernel_backend="torch")
    plain_tokens = tokens_of(plain.run(reqs))
    solo = {r.rid: oracle_completion(plain.engine, r) for r in reqs}
    solo_s = time.perf_counter() - t0
    cold = [r.rid for r in reqs if r.temperature == 0]
    hot = [r.rid for r in reqs if r.temperature > 0]
    hottest = [r.rid for r in reqs if r.temperature == 1.0]
    gates = {
        "each completion equals the request served alone": tokens == alone,
        "the torch backend's completions equal their solo generate_loop":
            plain_tokens == solo,
        "graphs and eager give the same tokens and launches":
            eager["tokens"] == tokens
            and eager["launches"] == first["launches"],
        "the temperature-0 requests give phase 4's tokens":
            all(tokens[r] == greedy["tokens"][r] for r in cold),
        "one decode program, nothing new built":
            sched.step_programs() == progs,
        "the same seeds give the same tokens": again["tokens"] == tokens,
        "other seeds give other tokens (greedy rows unchanged)":
            any(reseeded["tokens"][r] != tokens[r] for r in hot)
            and all(reseeded["tokens"][r] == tokens[r] for r in cold),
        "at t = 1.0 a token differs from the greedy one":
            any(tokens[r] != greedy["tokens"][r] for r in hottest),
    }
    for run in (first, again, reseeded, eager):
        launch_gate(mode, cfg, run["steps"], run["chunks"],
                    run["launches"])
    failed = [k for k, ok in gates.items() if not ok]
    log(f"sampled {mode}: 6 requests at temperatures {list(SAMPLED_TEMPS)}, "
        f"seeds {list(SAMPLED_SEEDS)}; launches {first['launches']} over "
        f"{first['steps']} decode steps + {first['chunks']} chunks (252 MVM "
        f"+ 36 attention a step or chunk); programs {sched.step_programs()}; "
        f"solo runs {solo_s:.1f} s; gates failed: {failed}")
    if failed:
        raise AssertionError(f"sampled {mode}: {failed}")
    if mode == "pum":
        # not a gate: the cuda backend against the contiguous oracle
        diff = {}
        for r in reqs:
            want = oracle_completion(sched.engine, r)
            diff[r.rid] = next((i for i, (a, b) in enumerate(
                zip(tokens[r.rid], want)) if a != b), None)
        log(f"sampled {mode}: the cuda backend's completions against "
            f"generate_loop on the cuda backend (contiguous cache, plain "
            f"attention): first differing token by request {diff} (None: "
            f"equal)")
    replay_ms = step_device_ms(sched, temps=[0.0, 0.7, 1.0, 0.7])
    log(f"sampled {mode}: decode_ms_per_step graphs / eager "
        f"{again['decode_ms']:.3f} / {eager['decode_ms']:.3f}, tokens_per_s "
        f"{again['tokens_per_s']:.2f} / {eager['tokens_per_s']:.2f}; a "
        f"decode replay {replay_ms:.4f} ms of device time (phases 4-5, every "
        f"row greedy: {greedy['replay_ms']:.4f}); the sampler alone "
        f"{sampler_ms:.4f} ms = {100 * sampler_ms / replay_ms:.1f} % of the "
        f"replay on {smi}")
    return launches


def sampled_phase(greedy: dict[str, dict], smi: str) -> dict[str, int]:
    """Phase 8; returns each kernel's launches on its main path (the
    CLI's sampled run in each mode)."""
    import gc
    import torch
    dev = torch.device("cuda", 0)
    sampler_ms = check_sampler(dev, smi)
    launches: dict[str, int] = {}
    for mode in ("pum", "int8"):
        for k, v in sampled_run(mode, greedy[mode], sampler_ms,
                                smi).items():
            launches[k] = launches.get(k, 0) + v
        gc.collect()
        torch.cuda.empty_cache()
    log("greedy decode_ms_per_step with the sampler in the decode graph "
        "(phases 4-5b, graphs / eager): " + ", ".join(
            f"{m} {greedy[m]['graph_ms']:.3f} / {greedy[m]['eager_ms']:.3f}"
            f" (before the sampler, graphs: {PRE_SAMPLER_GREEDY_MS[m]})"
            for m in SERVE_MODES)
        + f" on {smi}")
    return launches


# ---------------------------------------------------------------------------
# Phase 9: contiguous serving (contiguous windows, online softmax, the
# static batch)
# ---------------------------------------------------------------------------

# phase 4's trace served from contiguous windows: the CLI's defaults
# but for the KV layout (no blocks, so no chunked prefill)
CONTIG_ARGS = [a for a in SERVE_ARGS if a != "--chunked-prefill"]
CONTIG_ARGS[CONTIG_ARGS.index("--kv-block-size") + 1] = "0"
# one request of LONG_PROMPT tokens, past 2 * CHUNK_Q: its prefill runs
# the online softmax at full width, and every row of the scheduler then
# attends over a window of LONG_MAX_LEN keys
LONG_PROMPT, LONG_TOKENS = 4096, 16
LONG_MAX_LEN = LONG_PROMPT + LONG_TOKENS + 1
LONG_TEMP, LONG_SEED = 0.7, 2001
# the static batch of the reference CLI's default run
STATIC_ARGS = ["--arch", "qwen2.5-3b", "--batch-slots", "0", "--batch",
               "4", "--prompt-len", "64", "--gen", "16", "--seed", "0",
               "--device", "cuda"]
STATIC_TEMPS = (0.0, 0.7)
# _chunked_attention against the plain composition, bf16 K/V: each
# rounds p to bf16 (2^-8 relative; the online softmax rounds it against
# the running max, the plain one after normalising) and its p @ V
# products to bf16 (the online softmax each key block's partial sum,
# the plain one the output), so each is within 2^-7 of the exact
# output, relative to E = sum_t p_t |v_t|, the p-weighted mean |V| of
# that output element: |chunked - plain| <= 2^-6 E, plus 1e-6 for the
# f32 sums' order (scores and exp agree to ~1e-7 relative).  E is
# read in the same run, from the plain composition's f32 probabilities.
CHUNK_ATTN_REL = 2.0 ** -6
CHUNK_ATTN_ABS = 1e-6
# K1 / K2 at a monolithic prefill's M on Qwen2.5-3B's gate/up shape
PREFILL_MVM = (LONG_PROMPT, 2048, 11008)


def check_chunked_attention(dev, smi: str) -> None:
    """One layer's ``_chunked_attention`` at the 4096-token prompt's
    shapes (Qwen2.5-3B's 2 KV heads of 8 queries, hd 128, a window of
    LONG_MAX_LEN bf16 keys) against the plain composition over the same
    queries and keys, within the bound derived at CHUNK_ATTN_REL, and
    both timed."""
    import torch
    from repro_torch.kernels.paged_attention import ref
    from repro_torch.models import attention
    g = torch.Generator(device=dev).manual_seed(11)
    s, t = LONG_PROMPT, LONG_MAX_LEN
    q = torch.randn((1, s, 2, 8, 128), generator=g, device=dev).to(
        torch.bfloat16)
    k, v = (torch.randn((1, t, 2, 128), generator=g, device=dev).to(
        torch.bfloat16) for _ in range(2))
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    mask = torch.arange(t, device=dev)[None, :] <= torch.arange(
        s, device=dev)[:, None]
    got = attention._chunked_attention(q, k, v, zero, 0.0)
    plain = ref.plain_attention(q, k, v, mask, 0.0).float()
    scores = torch.einsum("bskgd,btkd->bksgt", q.float(), k.float()) \
        / math.sqrt(128)
    probs = ref.softmax(torch.where(mask[None, None, :, None, :], scores,
                                    torch.full((), ref.NEG_INF,
                                               device=dev)), 0.0)
    weighted = torch.einsum("bksgt,btkd->bskgd", probs, v.float().abs())
    del scores, probs
    err = (got - plain).abs()
    bound = CHUNK_ATTN_REL * weighted + CHUNK_ATTN_ABS
    finite = bool(torch.isfinite(got).all())
    worst = (err / bound).max().item()
    ms = event_ms(lambda: attention._chunked_attention(q, k, v, zero, 0.0),
                  reps=3)
    plain_ms = event_ms(lambda: ref.plain_attention(q, k, v, mask, 0.0),
                        reps=3)
    log(f"chunked attention S={s} T={t} KV=2 G=8 hd=128 bf16: max|chunked "
        f"- plain| = {err.max().item():.3g}, at most {worst:.3f} of the "
        f"bound 2^-6 E + 1e-6 (max E {weighted.max().item():.3g}, max|out| "
        f"{plain.abs().max().item():.3g}), finite {finite} | online "
        f"softmax {ms:.3f} ms, plain composition {plain_ms:.3f} ms on {smi}")
    if not finite or worst > 1.0:
        raise AssertionError("chunked attention outside its bound")


def check_prefill_mvm(dev, gpu_name: str) -> dict[str, dict]:
    """K1 and K2 alone at a monolithic prefill's M (PREFILL_MVM), bit for
    bit against their plain versions, timed beside their bounds and
    ``torch._int_mm``.  Returns each kernel's row."""
    import torch
    from repro_torch.core import bitslice
    from repro_torch.kernels import registry
    from repro_torch.kernels.bitslice_mvm import ops
    bw, _, int8_rate = peaks(gpu_name)
    m, k, n = PREFILL_MVM
    g = torch.Generator(device=dev).manual_seed(12)
    wq = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                       dtype=torch.int32)
    planes = bitslice.slice_planes_signed(wq, 8, 2).to(torch.int8)
    one = wq.to(torch.int8)[None]
    x = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                      dtype=torch.int32).to(torch.int8)
    scale = torch.rand((m, 1), generator=g, device=dev) * 1e-3
    calls = {
        "bitslice_mvm_scaled": lambda backend: ops.bitslice_mvm_planes_scaled(
            x, planes, scale, backend=backend),
        "bitslice_mvm": lambda backend: ops.bitslice_mvm_planes(
            x, one, bits_per_slice=8, backend=backend)}
    planes_of = {"bitslice_mvm_scaled": 4, "bitslice_mvm": 1}
    lib = device_ms(lambda: torch._int_mm(x, one[0]), iters=5)
    plan = ops.mvm_plan(m, k, n, 4, registry.device_props(dev.index))
    rows = {}
    for name, call in calls.items():
        got, want = call("cuda"), call("torch")
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not torch.equal(got, want) or not deterministic(
                lambda: call("cuda")):
            raise AssertionError(f"{name} at M={m} K={k} N={n}: max|diff| "
                                 f"{err}, or two calls differ")
        del got, want
        ps = planes_of[name]
        out_bytes = 4 * m * n
        nbytes = m * k + ps * k * n + out_bytes + (4 * m if ps == 4 else 0)
        by_bytes = nbytes / bw * 1e3
        by_ops = mvm_ops(m, k, n) / int8_rate * 1e3
        t = device_ms(lambda: call("cuda"), iters=5)
        p = device_ms(lambda: call("torch"), iters=2, reps=2)
        bound = max(by_bytes, by_ops)
        log(f"prefill mvm {name} M={m} K={k} N={n} S={ps} ({plan.row_tiles} "
            f"row tiles of {plan.mt}, {plan.col_tiles} column tiles): exact, "
            f"two calls bit-equal | kernel {t:.4f} ms (plain {p:.4f}, bound "
            f"{bound:.4f} by {'bytes' if by_bytes >= by_ops else 'ops'}, "
            f"{share(bound, t)} of bound) | _int_mm {lib:.4f} ms")
        rows[name] = dict(shape=f"M={m} K={k} N={n} S={ps}", max_abs_err=err,
                          ms=t, plain_ms=p, bound_ms=bound,
                          bound_by="bytes" if by_bytes >= by_ops
                          else "operations", library_ms=lib)
    return rows


def first_difference(a: dict, b: dict) -> dict:
    """By request: the first token where ``a`` and ``b`` differ (None:
    equal)."""
    return {rid: next((i for i, (x, y) in enumerate(zip(a[rid], b[rid]))
                       if x != y), None) for rid in a}


def long_request(vocab: int):
    """The LONG_PROMPT-token request, its prompt drawn from LONG_SEED."""
    import torch
    from repro_torch.serve import Request
    g = torch.Generator().manual_seed(LONG_SEED)
    prompt = torch.randint(0, vocab, (LONG_PROMPT,), generator=g).tolist()
    return Request(prompt, LONG_TOKENS, temperature=LONG_TEMP,
                   seed=LONG_SEED, rid=6)


def contiguous_long(sched, reqs, mode: str, smi: str) -> None:
    """Phase 4's requests at phase 8's temperatures plus the 4096-token
    request on a contiguous scheduler of LONG_MAX_LEN, gated against
    each request served alone through ``generate_loop`` on the same
    (cuda) backend; the long prompt's prefill timed and profiled."""
    import numpy as np
    import torch
    from repro_torch.kernels import registry
    from repro_torch.serve import ContinuousBatchingScheduler
    from repro_torch.serve import oracle_completion, prng
    cfg = sched.cfg
    big = ContinuousBatchingScheduler(cfg, sched.params,
                                      num_slots=sched.num_slots,
                                      max_len=LONG_MAX_LEN, kv_block_size=0,
                                      device=sched.device)
    long_req = long_request(cfg.vocab_size)
    trace = reqs + [long_req]
    run = timed_run(big, trace)
    launch_gate(mode, cfg, run["steps"], run["chunks"],
                run["launches"], paged=False)
    progs = big.step_programs()
    lengths = {len(r.prompt) for r in trace}
    t0 = time.perf_counter()
    solo = {r.rid: oracle_completion(big.engine, r) for r in trace}
    solo_s = time.perf_counter() - t0
    gates = {
        "each completion equals its request alone through generate_loop "
        "(cuda backend)": run["tokens"] == solo,
        "16 tokens a request": all(len(t) == 16
                                   for t in run["tokens"].values()),
        "one decode program, one prefill program a prompt length":
            progs == {"decode": 1, "prefill": {n: 1 for n in lengths}},
    }
    failed = [k for k, ok in gates.items() if not ok]
    replay_ms = step_device_ms(big)
    log(f"contiguous {mode} long: 6 requests at {list(SAMPLED_TEMPS)} + one "
        f"of {LONG_PROMPT} prompt tokens at t = {LONG_TEMP}, window "
        f"{LONG_MAX_LEN}; launches {run['launches']} over {run['steps']} "
        f"decode steps + {run['chunks']} prefills; programs {progs}; "
        f"decode_ms_per_step {run['decode_ms']:.3f}, a decode replay "
        f"{replay_ms:.4f} ms (4 rows over {LONG_MAX_LEN} keys), peak_mem_GB "
        f"{run['peak_gb']:.2f}; solo runs {solo_s:.1f} s; gates failed: "
        f"{failed}")
    if failed:
        diff = first_difference(run["tokens"], solo)
        raise AssertionError(f"contiguous {mode} long: {failed}; first "
                             f"differences {diff}")
    # the long prompt's prefill (time to first token): its program
    # replayed into the idle slot 0
    prog = big.program(LONG_PROMPT)
    key = prng.prng_key(long_req.seed).numpy()
    prog.stage([long_req.prompt], 0, key,
               np.float32(long_req.temperature).view(np.int32))
    ttft_ms = event_ms(prog.launch, reps=3)
    wall, by_name = kernel_times(prog.launch)
    if by_name:
        total = sum(by_name.values()) / 1e3
        mvm = sum(us for name, us in by_name.items()
                  if "bitslice_mvm_kernel" in name) / 1e3
        prof = (f"under the profiler {total:.3f} ms of kernels, the MVM "
                f"kernel {mvm:.3f} ms ({100 * mvm / total:.1f} %); top: "
                f"{top_kernels(by_name, 5)}")
    else:
        prof = "the profiler saw no device time (not measured)"
    log(f"contiguous {mode} long prefill: {LONG_PROMPT} tokens, one replay "
        f"{ttft_ms:.3f} ms of device time (time to first token), "
        f"{prog.launches} launches; {prof} on {smi}")
    del big
    registry.reset_launches()


def static_phase(mode: str, smi: str, args=None,
                 temps=STATIC_TEMPS) -> dict[str, int]:
    """The CLI's static batch (``--batch-slots 0``) with the compiled
    token loop and with ``--loop``, at each of STATIC_TEMPS: gated equal
    token for token, the same seed the same tokens with nothing new
    built, another step count the same two programs, graphs and eager
    equal, 252 MVM launches a forward and no attention kernel.  Returns
    the launches of its first run."""
    import gc
    import torch
    from repro_torch.kernels import registry
    from repro_torch.launch import serve
    from repro_torch.serve import ServeEngine
    first = None
    base = STATIC_ARGS if args is None else args
    gen = int(base[base.index("--gen") + 1])
    for temp in temps:
        args = base + ["--pum-mode", mode, "--temperature", str(temp)]
        # the per-token loop first, and only its tokens kept: one model
        # on the card at a time
        registry.reset_launches()
        loop = serve.main(args + ["--loop"])
        torch.cuda.synchronize()
        loop_launches = dict(registry.LAUNCHES)
        loop_out, loop_s = loop["out"], loop["wall_s"]
        del loop
        gc.collect()
        registry.reset_launches()
        scan = serve.main(args)
        torch.cuda.synchronize()
        scan_launches = dict(registry.LAUNCHES)
        if first is None:
            first = scan_launches
        eng, prompt = scan["engine"], scan["prompt"]
        cfg = eng.cfg
        progs = eng.scan_programs()
        t0 = time.perf_counter()
        again = eng.generate(prompt, gen, temperature=temp, seed=0)
        torch.cuda.synchronize()
        steady_s = time.perf_counter() - t0
        eager_eng = ServeEngine(cfg, eng.params, max_len=eng.max_len,
                                device=eng.device, cuda_graphs=False)
        t0 = time.perf_counter()
        eager = eager_eng.generate(prompt, gen, temperature=temp, seed=0)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        other = eng.generate(prompt, gen, temperature=temp, seed=1)
        half = eng.generate(prompt, gen // 2, temperature=temp, seed=0)
        for launches in (scan_launches, loop_launches):
            launch_gate(mode, cfg, gen, 0, launches, paged=False)
        gates = {
            "scan equals the per-token loop": torch.equal(scan["out"],
                                                          loop_out),
            "the same seed gives the same tokens, nothing new built":
                torch.equal(again, scan["out"])
                and eng.scan_programs() == progs
                and progs == {(4, 64, float(temp)): 1},
            "another step count replays the same two programs": torch.equal(
                half, scan["out"][:, :64 + gen // 2])
                and eng.scan_programs() == progs
                and eng.graphs_captured()[0] == 2,
            "graphs and eager give the same tokens": torch.equal(
                eager, scan["out"]),
            "another seed gives other tokens only when sampling":
                torch.equal(other, scan["out"]) == (temp == 0),
        }
        failed = [k for k, ok in gates.items() if not ok]
        toks = scan["tokens"]
        log(f"static {cfg.name} {mode} t={temp}: batch 4 x 64 prompt "
            f"tokens, {gen} "
            f"tokens each; scan (build included) {scan['wall_s']:.3f} s = "
            f"{toks / scan['wall_s']:.1f} tok/s, loop {loop_s:.3f} s = "
            f"{toks / loop_s:.1f} tok/s; steady scan {steady_s:.3f} s = "
            f"{toks / steady_s:.1f} tok/s ({1e3 * steady_s / gen:.3f} ms a "
            f"token step), eager scan {eager_s:.3f} s; prefill and decode "
            f"graphs ({sum(scan_launches.values())} kernel launches in the "
            f"first run) built in {eng.graphs_captured()[1]:.2f} s; gates "
            f"failed: {failed} on {smi}")
        if failed:
            raise AssertionError(f"static {mode} t={temp}: {failed}")
        del scan, eng, eager_eng
        gc.collect()
    return first


def contiguous_run(mode: str, smi: str) -> dict[str, int]:
    """Phase 9 in one mode; returns the launches of its main paths (the
    CLI's contiguous run and its first static batch)."""
    import dataclasses
    import gc
    import torch
    from repro_torch.kernels import registry
    from repro_torch.launch import serve
    from repro_torch.serve import ContinuousBatchingScheduler
    torch.cuda.reset_peak_memory_stats()
    registry.reset_launches()
    res = serve.main(CONTIG_ARGS + ["--pum-mode", mode])
    torch.cuda.synchronize()
    launches = dict(registry.LAUNCHES)
    sched = res["scheduler"]
    cfg = sched.cfg
    tokens = tokens_of(res["completions"])
    if len(tokens) != 6 or any(len(t) != 16 for t in tokens.values()):
        raise AssertionError(f"contiguous {mode}: completions {tokens}")
    launch_gate(mode, cfg, sched.decode_steps,
                sched.prefill_chunks, launches, paged=False)
    progs = sched.step_programs()
    lengths = {len(r.prompt) for r in res["requests"]}
    steady = timed_run(sched, res["requests"])
    eager = timed_run(like(sched, cuda_graphs=False), res["requests"])
    # paged == contiguous where both run the same arithmetic: the torch
    # backend, monolithic prefill on both
    plain_contig = like(sched, cuda_graphs=True, kernel_backend="torch")
    plain_paged = ContinuousBatchingScheduler(
        cfg, sched.params, num_slots=sched.num_slots, max_len=sched.max_len,
        kv_block_size=16, chunked_prefill=False, kernel_backend="torch",
        device=sched.device)
    contig_t = tokens_of(plain_contig.run(res["requests"]))
    paged_t = tokens_of(plain_paged.run(res["requests"]))
    del plain_contig, plain_paged
    # phase 4's paged scheduler on the cuda backend, for its tokens and
    # its decode replay beside the contiguous one, in turns
    paged = ContinuousBatchingScheduler(
        cfg, sched.params, num_slots=sched.num_slots, max_len=sched.max_len,
        kv_block_size=16, chunked_prefill=True, device=sched.device)
    paged_cuda = tokens_of(paged.run(res["requests"]))
    replay = {"paged": [], "contiguous": []}
    for name in ("paged", "contiguous", "contiguous", "paged"):
        replay[name].append(step_device_ms(
            paged if name == "paged" else sched))
    del paged
    gates = {
        "one decode program, one prefill program a prompt length, each a "
        "graph": progs == {"decode": 1, "prefill": {n: 1 for n in lengths}}
        and res["graphs"] == 1 + len(lengths),
        "a second run builds nothing and gives the same tokens":
            sched.step_programs() == progs and steady["tokens"] == tokens,
        "graphs and eager give the same tokens and launches":
            eager["tokens"] == tokens
            and eager["launches"] == steady["launches"],
        "contiguous equals paged on the torch backend (monolithic "
        "prefill)": contig_t == paged_t,
    }
    for run in (steady, eager):
        launch_gate(mode, cfg, run["steps"], run["chunks"],
                    run["launches"], paged=False)
    failed = [k for k, ok in gates.items() if not ok]
    log(f"contiguous {mode}: 6 requests x 16 tokens, {steady['steps']} decode "
        f"steps + {steady['chunks']} prefills; launches {launches} (first "
        f"run); programs {progs}; decode_ms_per_step graphs / eager "
        f"{steady['decode_ms']:.3f} / {eager['decode_ms']:.3f}, tokens_per_s "
        f"{steady['tokens_per_s']:.2f} / {eager['tokens_per_s']:.2f}, "
        f"peak_mem_GB {steady['peak_gb']:.2f}; a decode replay, paged / "
        f"contiguous / contiguous / paged: {replay['paged'][0]:.4f} / "
        f"{replay['contiguous'][0]:.4f} / {replay['contiguous'][1]:.4f} / "
        f"{replay['paged'][1]:.4f} ms; first tokens differing from the "
        f"paged scheduler's on the cuda backend (K3) "
        f"{first_difference(tokens, paged_cuda)}, from the torch backend's "
        f"{first_difference(tokens, contig_t)}; "
        f"gates failed: {failed} on {smi}")
    if failed:
        raise AssertionError(f"contiguous {mode}: {failed}")
    reqs = [dataclasses.replace(r, temperature=t, seed=s) for r, t, s in
            zip(res["requests"], SAMPLED_TEMPS, SAMPLED_SEEDS)]
    contiguous_long(sched, reqs, mode, smi)
    del res, sched, eager
    gc.collect()
    torch.cuda.empty_cache()
    for k, v in static_phase(mode, smi).items():
        launches[k] = launches.get(k, 0) + v
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def contiguous_phase(dev, gpu_name: str,
                     smi: str) -> tuple[dict[str, int], dict[str, dict]]:
    """Phase 9; returns each kernel's launches on its main paths and K1's
    and K2's rows at a prefill's M."""
    check_chunked_attention(dev, smi)
    rows = check_prefill_mvm(dev, gpu_name)
    launches: dict[str, int] = {}
    for mode in ("pum", "int8"):
        for k, v in contiguous_run(mode, smi).items():
            launches[k] = launches.get(k, 0) + v
    return launches, rows


# ---------------------------------------------------------------------------
# Phase 10: the xLSTM family (mLSTM and sLSTM mixers, per-slot state)
# ---------------------------------------------------------------------------

# phase 4's trace on xLSTM-350M: paged (blocks of 16, chunked prefill; it
# pages no KV, so a request takes 0 blocks) and from contiguous windows;
# and the static batch
XLSTM_ARGS = ["--arch", "xlstm-350m"] + SERVE_ARGS[2:]
XLSTM_CONTIG_ARGS = ["--arch", "xlstm-350m"] + CONTIG_ARGS[2:]
XLSTM_STATIC_ARGS = ["--arch", "xlstm-350m"] + STATIC_ARGS[2:]
# xLSTM-350M's projections by (K, N), counted over a forward pass of its
# 18 mLSTM (qkv; i and f, N = heads = 4; output gate; out) and 6 sLSTM
# (z, i, f, o; out) layers: 120
XLSTM_LAYERS = 24
XLSTM_MVM = {(1024, 6144): 18, (1024, 4): 36, (1024, 2048): 42,
             (2048, 1024): 24}
# Qwen2.5-3B's KV bytes a slot at the same window, for comparison: 36
# layers x K and V x 2 KV heads x 128 lanes x 2 bytes a position
QWEN_KV_BYTES_A_POSITION = 36 * 2 * 2 * 128 * 2


def check_xlstm_mvm(dev) -> list[dict]:
    """K1 and K2 at xLSTM-350M's shapes, N = 4 (mLSTM's gates, padded
    to 16 columns on the kernel) among them, at M in {1, 4, 16}."""
    return mvm_sweep(dev, XLSTM_MVM, XLSTM_LAYERS, "xLSTM-350M", MVM_ROWS)


def recurrent_snapshot(sched) -> list:
    from repro_torch.models import lm
    return [t.clone() for t in lm.recurrent_tensors(sched.cfg, sched.states)]


def advance_once(sched) -> bool:
    """The compiled step's rule on the recurrent steps: a fresh
    scheduler of ``sched``'s geometry with graphs, one without, the same
    two requests admitted and ticked; after every call (each program
    built at its first: warm-up, capture, replay) the recurrent state
    and the tokens of both are equal bit for bit."""
    import torch
    from repro_torch.serve import Request
    runs = {}
    for graphs in (True, False):
        s = like(sched, graphs)
        snaps, events = [], []
        for req in (Request(list(range(1, 21)), 3, rid=0),
                    Request(list(range(30, 37)), 3, temperature=0.7,
                            seed=5, rid=1)):
            s.start_request(req)
            snaps.append(recurrent_snapshot(s))
        for step in range(4):
            events += s.tick(step).events
            snaps.append(recurrent_snapshot(s))
        torch.cuda.synchronize()
        runs[graphs] = events, snaps
        del s
    (ev_g, sn_g), (ev_e, sn_e) = runs[True], runs[False]
    return ev_g == ev_e and len(ev_g) > 0 and all(
        torch.equal(a, b) for x, y in zip(sn_g, sn_e) for a, b in zip(x, y))


def nonfinite(sched) -> list[str]:
    """Where ``sched``'s recurrent states (by layer, leaf and row) or the
    last logits of any of its steps (by row) are not finite.  Each
    graph keeps its logits outside the pool the graphs share, so a
    step's logits hold until its own next call (``CompiledStep``)."""
    import torch
    from repro_torch.models import transformer

    def rows(t):
        bad = ~torch.isfinite(t.reshape(t.shape[0], -1)).all(dim=1)
        return bad.nonzero().flatten().tolist()

    out = []
    for j, st in enumerate(sched.states):
        if transformer.layer_kinds(sched.cfg, j)[0] == "attn":
            continue
        out += [f"layer {j} {name} rows {r}" for name, t in st.items()
                if (r := rows(t))]
    out += [f"step {key} logits rows {r}"
            for key, t in sched.last_logits().items() if (r := rows(t))]
    return out


def recurrence_ms(cfg, slots: int) -> float:
    """Device time of the recurrences of one decode step alone: every
    mLSTM and sLSTM layer's cell at ``slots`` rows on random f32 inputs
    (``models/xlstm.py``'s ``_mlstm_step`` and ``_slstm_step``)."""
    import torch
    from repro_torch.models import transformer, xlstm
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(4)
    inner, heads, hd = xlstm._dims(cfg)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    kinds = [transformer.layer_kinds(cfg, j)[0]
             for j in range(cfg.num_layers)]
    m_state = (rnd(slots, heads, hd, hd), rnd(slots, heads, hd).abs(),
               rnd(slots, heads))
    m_in = (rnd(slots, heads, hd), rnd(slots, heads, hd),
            rnd(slots, heads, hd), rnd(slots, heads), rnd(slots, heads))
    s_state = (rnd(slots, inner), rnd(slots, inner).abs(), rnd(slots, inner))
    s_in = tuple(rnd(slots, inner) for _ in range(4))

    def cells():
        for kind in kinds:
            if kind == "mlstm":
                xlstm._mlstm_step(m_state, *m_in)
            else:
                xlstm._slstm_step(s_state, s_in)
    return device_ms(cells, iters=2)


def xlstm_measure(sched, contig, smi: str) -> None:
    """Phase 10's numbers in one mode: a decode replay's device time and
    its split under the profiler, the recurrences alone, a 64-token
    prompt's prefill, and the state bytes a slot."""
    import numpy as np
    from repro_torch.models import lm
    from repro_torch.serve import prng
    mode, cfg = sched.cfg.pum.mode, sched.cfg
    replay_ms = step_device_ms(sched)
    prog = sched.program("decode")
    _, by_name = kernel_times(prog.launch)
    if by_name:
        total = sum(by_name.values()) / 1e3
        mvm = sum(us for name, us in by_name.items()
                  if "bitslice_mvm_kernel" in name) / 1e3
        prof = (f"under the profiler {total:.3f} ms of kernels, the MVM "
                f"kernel {mvm:.3f} ms ({100 * mvm / total:.1f} %); top: "
                f"{top_kernels(by_name, 5)}")
    else:
        prof = "the profiler saw no device time (not measured)"
    rec_ms = recurrence_ms(cfg, sched.num_slots)
    # a 64-token prompt's admission prefill into the idle slot 0
    prompt = list(range(1, 65))
    pre = contig.program(64, [prompt], 0, prng.prng_key(1).numpy(),
                         np.float32(0.0).view(np.int32))
    pre.stage([prompt], 0, prng.prng_key(1).numpy(),
              np.float32(0.0).view(np.int32))
    prefill_ms = event_ms(pre.launch, reps=3)
    state_bytes = sum(t.nbytes for t in lm.recurrent_tensors(
        cfg, sched.states)) / sched.num_slots
    qwen_bytes = QWEN_KV_BYTES_A_POSITION * sched.max_len
    log(f"xlstm {mode} decode step ({sched.num_slots} slots): a graph "
        f"replay {replay_ms:.4f} ms of device time; {prof}; the "
        f"recurrences alone (18 mLSTM + 6 sLSTM cells at {sched.num_slots} "
        f"rows) {rec_ms:.4f} ms = {100 * rec_ms / replay_ms:.1f} % of the "
        f"replay on {smi}")
    log(f"xlstm {mode} prefill of a 64-token prompt (contiguous admission, "
        f"one replay): {prefill_ms:.3f} ms of device time, "
        f"{dict(pre.launches)} launches; recurrent state "
        f"{state_bytes / 2**20:.2f} MiB a slot against Qwen2.5-3B's KV "
        f"{qwen_bytes / 2**20:.2f} MiB a slot at the same window "
        f"({sched.max_len} positions) on {smi}")


def xlstm_run(mode: str, smi: str) -> dict[str, int]:
    """Phase 10 in one mode: the CLI paged and contiguous (its main
    paths, whose launches are returned with the static batch's), then on
    their schedulers phase 8's sampled requests, with every gate."""
    import dataclasses
    import gc
    import torch
    from repro_torch.kernels import registry
    from repro_torch.launch import serve
    from repro_torch.serve import oracle_completion
    t0 = time.perf_counter()
    launches: dict[str, int] = {}
    runs = {}
    for layout, args in (("paged", XLSTM_ARGS),
                         ("contiguous", XLSTM_CONTIG_ARGS)):
        registry.reset_launches()
        res = serve.main(args + ["--pum-mode", mode])
        torch.cuda.synchronize()
        counts = dict(registry.LAUNCHES)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        sched = res["scheduler"]
        launch_gate(mode, sched.cfg, sched.decode_steps,
                    sched.prefill_chunks, counts, paged=False)
        progs = sched.step_programs()
        built = [progs["decode"], *next(v for k, v in progs.items()
                                        if k != "decode").values()]
        comps = res["completions"]
        if len(comps) != 6 or any(len(c.tokens) != 16
                                  for c in comps.values()) \
                or any(n != 1 for n in built) \
                or res["graphs"] != len(built):
            raise AssertionError(f"xlstm {mode} {layout}: completions "
                                 f"{tokens_of(comps)}, programs {progs}, "
                                 f"{res['graphs']} graphs")
        runs[layout] = res
        log(f"xlstm {mode} {layout}: {sched.cfg.name} {sched.cfg.num_layers} "
            f"layers d_model {sched.cfg.d_model}, 6 requests x 16 tokens, "
            f"{sched.decode_steps} decode steps + {sched.prefill_chunks} "
            f"prefill {'chunks' if sched.paged else 'prompts'}; launches "
            f"{counts} (replays counted); programs {progs}, {res['graphs']} "
            f"graphs built in {res['build_s']:.2f} s")
    paged, contig = runs["paged"]["scheduler"], runs["contiguous"]["scheduler"]
    greedy = tokens_of(runs["paged"]["completions"])
    reqs = [dataclasses.replace(r, temperature=t, seed=s) for r, t, s in
            zip(runs["paged"]["requests"], SAMPLED_TEMPS, SAMPLED_SEEDS)]
    progs = {k: s.step_programs() for k, s in (("paged", paged),
                                               ("contiguous", contig))}
    again = timed_run(paged, runs["paged"]["requests"])
    sampled = {"paged": timed_run(paged, reqs),
               "contiguous": timed_run(contig, reqs)}
    eager = {"paged": timed_run(like(paged, cuda_graphs=False), reqs),
             "contiguous": timed_run(like(contig, cuda_graphs=False), reqs)}
    t1 = time.perf_counter()
    solo = {r.rid: oracle_completion(paged.engine, r) for r in reqs}
    solo_s = time.perf_counter() - t1
    rule = {k: advance_once(s) for k, s in (("paged", paged),
                                            ("contiguous", contig))}
    bad = {k: nonfinite(s) for k, s in (("paged", paged),
                                        ("contiguous", contig))}
    toks = sampled["paged"]["tokens"]
    gates = {
        "each completion equals its request alone through generate_loop "
        "(cuda backend), paged": toks == solo,
        "and contiguous": sampled["contiguous"]["tokens"] == solo,
        "the greedy CLI runs give the same tokens paged and contiguous":
            greedy == tokens_of(runs["contiguous"]["completions"]),
        "a second run builds nothing and gives the same tokens":
            again["tokens"] == greedy
            and paged.step_programs() == progs["paged"],
        "one decode program for greedy and sampled rows, nothing new "
        "built": all(s.step_programs() == progs[k] and progs[k]["decode"]
                     == 1 for k, s in (("paged", paged),
                                       ("contiguous", contig))),
        "graphs and eager give the same tokens and launches": all(
            eager[k]["tokens"] == sampled[k]["tokens"]
            and eager[k]["launches"] == sampled[k]["launches"]
            for k in sampled),
        "a recurrent step built and called once leaves one eager call's "
        "state (paged chunk and decode, contiguous prefill and decode)":
            all(rule.values()),
        "states and logits finite": not bad["paged"]
            and not bad["contiguous"],
    }
    for run in (again, *sampled.values(), *eager.values()):
        launch_gate(mode, paged.cfg, run["steps"], run["chunks"],
                    run["launches"], paged=False)
    failed = [k for k, ok in gates.items() if not ok]
    log(f"xlstm {mode}: 6 requests at temperatures {list(SAMPLED_TEMPS)}, "
        f"seeds {list(SAMPLED_SEEDS)}; paged {sampled['paged']['steps']} "
        f"decode steps + {sampled['paged']['chunks']} chunks, launches "
        f"{sampled['paged']['launches']}; solo runs {solo_s:.1f} s; first "
        f"differences from the solo runs paged "
        f"{first_difference(toks, solo)}, contiguous "
        f"{first_difference(sampled['contiguous']['tokens'], solo)}; "
        f"non-finite {bad}; gates failed: {failed}")
    for k in sampled:
        log(f"xlstm {mode} {k}: decode_ms_per_step graphs / eager "
            f"{sampled[k]['decode_ms']:.3f} / {eager[k]['decode_ms']:.3f}, "
            f"tokens_per_s {sampled[k]['tokens_per_s']:.2f} / "
            f"{eager[k]['tokens_per_s']:.2f}, peak_mem_GB "
            f"{sampled[k]['peak_gb']:.2f} on {smi}")
    if failed:
        raise AssertionError(f"xlstm {mode}: {failed}")
    backend_parity(paged)
    xlstm_measure(paged, contig, smi)
    del runs, paged, contig, eager
    gc.collect()
    torch.cuda.empty_cache()
    for k, v in static_phase(mode, smi, XLSTM_STATIC_ARGS,
                             temps=(0.0,)).items():
        launches[k] = launches.get(k, 0) + v
    gc.collect()
    torch.cuda.empty_cache()
    log(f"xlstm {mode}: phase in {time.perf_counter() - t0:.1f} s")
    return launches


def xlstm_phase(smi: str) -> dict[str, int]:
    """Phase 10; returns each kernel's launches on its main paths."""
    launches: dict[str, int] = {}
    for mode in ("pum", "int8"):
        for k, v in xlstm_run(mode, smi).items():
            launches[k] = launches.get(k, 0) + v
    return launches


def xlstm_rows(cases: list[dict]) -> dict[str, list[dict]]:
    """K1's and K2's rows at xLSTM-350M's shapes, for the kernels line."""
    return {name: [c[kern] for c in cases]
            for name, kern in (("bitslice_mvm_scaled", "K1"),
                               ("bitslice_mvm", "K2"))}


# ---------------------------------------------------------------------------
# Phase 11: the MoE family (top-k routed experts, capacity-bounded dispatch)
# ---------------------------------------------------------------------------

# phase 4's trace on OLMoE-1B-7B: paged (blocks of 16, chunked prefill)
# and from contiguous windows; the static batch; granite-moe-1b-a400m
# paged
OLMOE_ARGS = ["--arch", "olmoe-1b-7b"] + SERVE_ARGS[2:]
OLMOE_CONTIG_ARGS = ["--arch", "olmoe-1b-7b"] + CONTIG_ARGS[2:]
OLMOE_STATIC_ARGS = ["--arch", "olmoe-1b-7b"] + STATIC_ARGS[2:]
GRANITE_ARGS = ["--arch", "granite-moe-1b-a400m"] + SERVE_ARGS[2:]
# OLMoE-1B-7B's projections on the MVM kernels: q, k, v and o of its 16
# MHA layers, all 2048 x 2048 (the router and the experts are float
# products): 64 a forward pass
OLMOE_LAYERS = 16
OLMOE_MVM = {(2048, 2048): 64}
# device kernels of a decode replay by name, for its split under the
# profiler; "float GEMMs" holds the expert bmms, and with them the f32
# router and lm head
KERNEL_CLASSES = [
    ("K1/K2", ("bitslice_mvm",)),
    ("K3", ("paged_attention", "store_kernel")),
    ("expert cast (copies)", ("copy_kernel",)),
    ("float GEMMs", ("gemm", "gemv", "xmma", "cutlass", "cublas", "nvjet")),
    ("sort and ranks", ("sort", "radix", "searchsorted")),
    ("gathers and scatters", ("index", "scatter", "gather")),
]


def no_drop(cfg):
    """``cfg`` at capacity factor E / k: an expert's capacity is then
    every row of a call, and no assignment is dropped."""
    import dataclasses
    return cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))


class routing:
    """Within ``with``, every ``moe.route`` call (one a layer of each
    forward pass, as ``moe_ffn`` makes it) is recorded in ``calls``: its
    router probabilities [T, E], the top-k experts it chose itself
    [T, k], its layer, its capacity and what its rows hold (``rows``:
    (request id, position), or None for a row that holds no request).
    ``label`` names the rows of the calls that follow; a scheduler
    given as ``sched`` names its own (its prompt dispatches and its
    decode steps, whose rows are its slots).  ``force(n, layer, rows,
    experts)`` may return other top-k experts for call ``n``, which it
    then routes to, gated by its own probabilities normalised as
    ``route`` does: a run can hold another run's routing.  Eager runs
    only: a graph replay runs no Python."""

    def __init__(self, layers: int, sched=None, force=None):
        self.layers, self.sched, self.force = layers, sched, force
        self.rows, self._admitting = None, None

    def label(self, rows) -> None:
        self.rows = rows

    def _slot_rows(self) -> list:
        s = self.sched
        return [(s._slot_req[i].rid, len(s._slot_req[i].prompt)
                 + len(s._slot_toks[i]) - 1) if s._active[i] else None
                for i in range(s.num_slots)]

    def __enter__(self):
        from repro_torch.models import moe
        self.calls, self.inner = [], moe.route

        def route(p, xf, cfg):
            logits, probs, vals, idx = self.inner(p, xf, cfg)
            n, layer = len(self.calls), len(self.calls) % self.layers
            decode = self.rows is None and self.sched is not None
            rows = self._slot_rows() if decode else self.rows
            self.calls.append(dict(probs=probs, idx=idx, rows=rows,
                                   layer=layer, decode=decode,
                                   cap=moe.capacity(xf.shape[0], cfg)))
            held = None if self.force is None else self.force(
                n, layer, rows, idx)
            if held is None:
                return logits, probs, vals, idx
            sel = probs.gather(-1, held)
            return logits, probs, sel / sel.sum(-1, keepdim=True), held

        moe.route = route
        s = self.sched
        if s is not None:
            dispatch, admit = s._dispatch, s._admit

            def labelled(key, *values):
                # a paged chunk: (tokens, start, table row, slot, ...); a
                # contiguous admission: the whole prompt from position 0
                rid, start = ((s._prefills[int(values[3])].req.rid,
                               int(values[1])) if s.paged
                              else (self._admitting, 0))
                self.rows = [(rid, start + j) for j in range(key)]
                try:
                    return dispatch(key, *values)
                finally:
                    self.rows = None

            def admitting(slot, req, step):
                self._admitting = req.rid
                return admit(slot, req, step)

            s._dispatch, s._admit = labelled, admitting
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route = self.inner
        if self.sched is not None:
            del self.sched._dispatch, self.sched._admit


def k_gaps(probs, k: int):
    """Each row's gap between its k-th and (k+1)-th largest probability:
    how far its router sits from choosing another expert."""
    import numpy as np
    top = -np.sort(-np.asarray(probs), axis=-1)
    return top[..., k - 1] - top[..., k]


def by_position(calls: list) -> dict:
    """The labelled rows of recorded calls, on the host: {(request id,
    position): {layer: (probabilities, experts)}}."""
    out: dict = {}
    for c in calls:
        if c["rows"] is None:
            continue
        probs, idx = c["probs"].cpu().numpy(), c["idx"].cpu().numpy()
        for r, lab in enumerate(c["rows"]):
            if lab is not None:
                out.setdefault(lab, {})[c["layer"]] = (probs[r], idx[r])
    return out


def held_to(ref: dict):
    """A ``routing`` force that routes each labelled row as ``ref`` (a
    ``by_position`` map) routed its request's position at that layer."""
    import numpy as np
    import torch

    def force(n, layer, rows, idx):
        hit = [(r, ref[lab][layer][1]) for r, lab in enumerate(rows or [])
               if lab in ref]
        if not hit:
            return None
        out = idx.clone()
        out[torch.tensor([r for r, _ in hit], device=idx.device)] = \
            torch.from_numpy(np.stack([e for _, e in hit])).to(out)
        return out

    return force


def swap_gap(p_ref, e_ref, e_got) -> float:
    """Where two top-k choices differ: the gap in the reference's
    probabilities between its expert and the other run's at the first
    rank where they differ (>= 0: the reference ranked its own first)."""
    import numpy as np
    j = int(np.nonzero(e_ref != e_got)[0][0])
    return float(p_ref[e_ref[j]] - p_ref[e_got[j]])


def moe_backend_parity(sched) -> tuple[float, float]:
    """``backend_parity`` for an MoE model, with the routing held: one
    chunk and one decode step on the ``cuda`` backend (run a), on the
    ``torch`` backend (b) and on ``cuda`` with layer 0's attention input
    moved by one bf16 ulp on every other channel (c), b and c routed as
    a routes (``routing(force=...)``: the same experts, gated by their
    own probabilities).  With the routing held the runs differ only by
    rounding, and these must hold: b's logits within c's change of a's
    (the bound) and b's greedy tokens a's; b's router probabilities
    within c's change of a's (the router's one-ulp sensitivity); and
    wherever b's router would itself choose other experts than a's, a's
    probabilities of the two experts within that sensitivity (a
    near-tie, counted).  Returns (the bound, the sensitivity): how far
    one ulp moves the logits and the router with the routing held."""
    import numpy as np
    import torch
    cfg, params = sched.cfg, sched.params
    layers, k = cfg.num_layers, cfg.moe.top_k
    with routing(layers) as ra:
        a = chunk_and_step(sched, params, "cuda")

    def held(n, layer, rows, idx):
        return ra.calls[n]["idx"]

    with routing(layers, force=held) as rb:
        b = chunk_and_step(sched, params, "torch")
    with routing(layers, force=held) as rc:
        c = chunk_and_step(sched, nudged(params), "cuda")
    if not all(bool(torch.isfinite(t).all()) for t in (a, b, c)):
        raise AssertionError("non-finite logits")
    if not len(ra.calls) == len(rb.calls) == len(rc.calls) == 2 * layers:
        raise AssertionError("the moe calls were not all recorded")
    err = (a - b).abs().max().item()
    bound = (c - a).abs().max().item()
    same = bool((a.argmax(-1) == b.argmax(-1)).all())
    top2 = torch.topk(a, 2, dim=-1).values
    margins = (top2[..., 0] - top2[..., 1]).flatten().tolist()

    def host(calls, key):
        return [x[key].cpu().numpy() for x in calls]

    pa, pb, pc = (host(r.calls, "probs") for r in (ra, rb, rc))
    ea, eb = host(ra.calls, "idx"), host(rb.calls, "idx")
    drift = max(float(np.abs(x - y).max()) for x, y in zip(pb, pa))
    sens = max(float(np.abs(x - y).max()) for x, y in zip(pc, pa))
    swaps = [(n, swap_gap(pa[n][r], ea[n][r], eb[n][r]))
             for n in range(len(ea))
             for r in np.nonzero((ea[n] != eb[n]).any(-1))[0]]
    gaps = np.concatenate([k_gaps(x, k) for x in pa])
    log(f"backend parity {cfg.name} {cfg.pum.mode} (capacity factor "
        f"{cfg.moe.capacity_factor}), routing held to the cuda run's: "
        f"chunk + decode logits max|cuda - torch| = {err:.4g}, bound "
        f"(one-ulp nudge of layer 0) = {bound:.4g}, max|logit| = "
        f"{b.abs().max().item():.4g}, the cuda run's top-2 margins "
        f"{[round(m, 4) for m in margins]}, greedy tokens equal: {same}; "
        f"router probabilities max|cuda - torch| = {drift:.3g}, the nudge's "
        f"(the router's one-ulp sensitivity) {sens:.3g}; {len(swaps)} rows "
        f"of {sum(len(x) for x in ea)} over {len(ea)} calls where the torch "
        f"router would choose otherwise, (call, gap) "
        f"{[(n, f'{g:.3g}') for n, g in swaps]}; the cuda run's k-th to "
        f"(k+1)-th probability gaps: median {float(np.median(gaps)):.3g}, "
        f"{100 * float((gaps <= sens).mean()):.1f} % within the "
        f"sensitivity")
    if bound == 0.0 or sens == 0.0:
        raise AssertionError("the nudge did not reach the logits or the "
                             "router")
    if err > bound or not same:
        raise AssertionError(f"backend parity failed: {err} > {bound} or "
                             f"greedy differs, routing held")
    if drift > sens:
        raise AssertionError(f"router probabilities part by {drift}, past "
                             f"the one-ulp sensitivity {sens}")
    if any(g > sens for _, g in swaps):
        raise AssertionError(f"a routing choice that differs past the "
                             f"one-ulp sensitivity {sens}: {swaps}")
    return bound, sens


def solo_routing(eng, requests, solo: dict) -> tuple[dict, dict]:
    """Each request alone on ``eng``, its prefill then one decode step a
    token along its ``solo`` tokens, as ``generate_loop`` ran it: its
    routing by position (``by_position``) and its top-2 logit margin
    before each token.  Its greedy tokens must be ``solo``'s."""
    import torch
    dev, layers = eng.device, eng.cfg.num_layers
    margins = {}
    with routing(layers) as rec, torch.inference_mode():
        for r in requests:
            prompt, toks = list(r.prompt), solo[r.rid]
            rec.label([(r.rid, j) for j in range(len(prompt))])
            states, lg = eng.prefill(torch.tensor([prompt],
                                                  dtype=torch.int32,
                                                  device=dev))
            out = [lg]
            for i, tok in enumerate(toks[:-1]):
                rec.label([(r.rid, len(prompt) + i)])
                lg, states = eng.decode(states, torch.tensor(
                    [[tok]], dtype=torch.int32, device=dev),
                    len(prompt) + i)
                out.append(lg)
            lg = torch.cat(out, dim=1).float()[0]
            if lg.argmax(-1).tolist() != toks:
                raise AssertionError(f"request {r.rid} alone: greedy "
                                     f"{lg.argmax(-1).tolist()} != {toks}")
            top2 = torch.topk(lg, 2, dim=-1).values
            margins[r.rid] = (top2[:, 0] - top2[:, 1]).tolist()
    return by_position(rec.calls), margins


def no_drop_runs(sched, requests, graph_tokens: dict, solo: dict, ref: dict,
                 margins: dict, tie: float, sens: float
                 ) -> tuple[dict, list[str]]:
    """At a no-drop capacity factor each row is computed alone, up to the
    rounding of the products whose row count is the capacity.  An eager
    copy of ``sched`` serves ``requests`` (its tokens must be the graph
    run's, ``graph_tokens``) and another with every row routed as the
    request alone routed it (``ref``); against the requests alone
    (``solo``), with the routing held, the router probabilities must
    stay within the one-ulp sensitivity ``sens``, every choice the
    router would make otherwise must sit at a near-tie (a gap within
    ``sens``) and a first token difference at a near-tie of the logits
    (the solo top-2 margin within ``tie``, the one-ulp bound); a first
    difference of the run on its own routing must be the held run's, or
    follow a routing choice that differs.  Returns the eager tokens and
    the failures."""
    import numpy as np
    layers = sched.cfg.num_layers
    free = like(sched, cuda_graphs=False)
    with routing(layers, sched=free):
        own = tokens_of(free.run(requests))
    held = like(sched, cuda_graphs=False)
    with routing(layers, sched=held, force=held_to(ref)) as rec:
        kept = tokens_of(held.run(requests))
    got = by_position(rec.calls)
    failed, rows = [], {}
    for r in requests:
        p, n, want = len(r.prompt), len(solo[r.rid]), solo[r.rid]
        i_own = first_difference({0: own[r.rid]}, {0: want})[0]
        i_held = first_difference({0: kept[r.rid]}, {0: want})[0]
        drift, swaps = 0.0, []
        for pos in range(p + (n - 1 if i_held is None else i_held)):
            for layer, (pr, er) in ref[(r.rid, pos)].items():
                pg, eg = got[(r.rid, pos)][layer]
                drift = max(drift, float(np.abs(pg - pr).max()))
                if (eg != er).any():
                    swaps.append((pos, layer, swap_gap(pr, er, eg)))
        first = min(n if i_own is None else i_own,
                    n if i_held is None else i_held)
        rows[r.rid] = dict(own=i_own, held=i_held, drift=float(
            f"{drift:.3g}"), swaps=[(pos, layer, float(f"{g:.3g}"))
                                    for pos, layer, g in swaps[:3]],
            n_swaps=len(swaps), margin=None if i_held is None
            else round(margins[r.rid][i_held], 4))
        if drift > sens:
            failed.append(f"request {r.rid}: router probabilities part by "
                          f"{drift} > {sens}")
        if any(g > sens for _, _, g in swaps):
            failed.append(f"request {r.rid}: a routing choice past a "
                          f"near-tie {swaps}")
        if i_held is not None and margins[r.rid][i_held] > tie:
            failed.append(f"request {r.rid}: routing held, first "
                          f"difference at token {i_held} past a near-tie")
        if i_own != i_held and not any(pos < p + first
                                       for pos, _, _ in swaps):
            failed.append(f"request {r.rid}: on its own routing it first "
                          f"differs at {i_own}, held at {i_held}, with no "
                          f"routing choice differing before")
    if own != graph_tokens:
        failed.append("eager tokens differ from the graph run's")
    return dict(own=own, held=kept, rows=rows), failed


def moe_measure(sched, contig, requests, smi: str) -> None:
    """Phase 11's numbers in one mode: a decode replay's device time and
    its split under the profiler; the expert cast, the expert products
    and the rest of one layer's ``moe_ffn`` timed alone; a 64-token
    prompt's prefill; the share of assignments dropped a decode step."""
    import numpy as np
    import torch
    from repro_torch.models import moe
    from repro_torch.serve import prng
    mode, cfg, params = sched.cfg.pum.mode, sched.cfg, sched.params
    dev, b = sched.device, sched.num_slots
    replay_ms = step_device_ms(sched)
    _, by_name = kernel_times(sched.program("decode").launch)
    if by_name:
        total = sum(by_name.values()) / 1e3
        split = {name: 0.0 for name, _ in KERNEL_CLASSES}
        split["other"] = 0.0
        for kname, us in by_name.items():
            cls = next((name for name, keys in KERNEL_CLASSES
                        if any(k in kname for k in keys)), "other")
            split[cls] += us / 1e3
        prof = (f"under the profiler {total:.3f} ms of kernels: " + ", ".join(
            f"{k} {v:.3f} ms ({100 * v / total:.1f} %)"
            for k, v in split.items()) + f"; top: {top_kernels(by_name, 5)}")
    else:
        prof = "the profiler saw no device time (not measured)"
    experts = [blk["moe"][n] for blk in params["blocks"]
               for n in ("experts_wg", "experts_wu", "experts_wd")]

    def cast_all():
        for t in experts:
            t.to(torch.bfloat16)

    cast_ms = event_ms(cast_all, reps=3)
    blk = params["blocks"][0]["moe"]
    w = [blk[n].to(torch.bfloat16) for n in ("experts_wg", "experts_wu",
                                             "experts_wd")]
    g = torch.Generator(device=dev).manual_seed(5)
    e, d = cfg.moe.num_experts, cfg.d_model
    buf = torch.randn((e, 1, d), generator=g, device=dev).to(torch.bfloat16)

    def products():
        for _ in range(cfg.num_layers):
            act = torch.nn.functional.silu(torch.bmm(buf, w[0])) * \
                torch.bmm(buf, w[1])
            torch.bmm(act, w[2])

    bmm_ms = event_ms(products, reps=3)
    del w
    x = torch.randn((b, 1, d), generator=g, device=dev).to(torch.bfloat16)
    with torch.inference_mode():
        layer_ms = event_ms(lambda: moe.moe_ffn(blk, x, cfg, aux=False),
                            reps=5)
    rest_ms = layer_ms - (cast_ms + bmm_ms) / cfg.num_layers
    nbytes = sum(t.numel() for t in experts) * (4 + 2)
    log(f"moe {cfg.name} {mode} decode step ({b} slots): a graph replay "
        f"{replay_ms:.4f} ms of device time; {prof} on {smi}")
    log(f"moe {cfg.name} {mode} alone: the per-call expert cast of all "
        f"{cfg.num_layers} layers {cast_ms:.3f} ms ({nbytes / 1e9:.1f} GB "
        f"read and written, bound {nbytes / peaks(smi)[0] * 1e3:.3f} ms); "
        f"the expert products at capacity 1 (3 bmms a layer over all {e} "
        f"experts) {bmm_ms:.3f} ms; one layer's moe_ffn {layer_ms:.3f} ms, "
        f"of it the router, sort, ranks, gathers and combine "
        f"{rest_ms:.3f} ms (the layer less its cast and products) on {smi}")
    prompt = list(range(1, 65))
    pre = contig.program(64, [prompt], 0, prng.prng_key(1).numpy(),
                         np.float32(0.0).view(np.int32))
    pre.stage([prompt], 0, prng.prng_key(1).numpy(),
              np.float32(0.0).view(np.int32))
    prefill_ms = event_ms(pre.launch, reps=3)
    shares = dropped_shares(sched, requests)
    log(f"moe {cfg.name} {mode}: a 64-token prefill (contiguous admission, "
        f"one replay) {prefill_ms:.3f} ms of device time, "
        f"{dict(pre.launches)} launches; decode capacity "
        f"{moe.capacity(b, cfg)} an expert, assignments dropped a decode "
        f"step (over {len(shares)} layer calls of the trace): mean "
        f"{100 * float(np.mean(shares)):.1f} %, max "
        f"{100 * max(shares):.1f} % on {smi}")


def dropped_shares(sched, requests) -> list[float]:
    """The share of assignments dropped at each MoE layer of each decode
    step of ``requests`` served by an eager copy of ``sched``, idle
    rows' assignments included (they take capacity too)."""
    from repro_torch.models import moe
    eager = like(sched, cuda_graphs=False)
    with routing(sched.cfg.num_layers, sched=eager) as rec:
        eager.run(requests)
    e = sched.cfg.moe.num_experts
    return [float((moe.dispatch_slots(c["idx"], e) >= c["cap"]).float()
                  .mean()) for c in rec.calls if c["decode"]]


def moe_run(mode: str, smi: str) -> dict[str, int]:
    """Phase 11 in one mode: the CLI paged and contiguous (its main
    paths, whose launches are returned with the static batch's), then
    the gates at the config's own capacity factor and at E / k."""
    import gc
    import numpy as np
    import torch
    from repro_torch.kernels import registry
    from repro_torch.launch import serve
    from repro_torch.serve import (ContinuousBatchingScheduler,
                                   oracle_completion)
    t0 = time.perf_counter()
    launches: dict[str, int] = {}
    runs = {}
    for layout, args in (("paged", OLMOE_ARGS),
                         ("contiguous", OLMOE_CONTIG_ARGS)):
        registry.reset_launches()
        res = serve.main(args + ["--pum-mode", mode])
        torch.cuda.synchronize()
        counts = dict(registry.LAUNCHES)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        sched = res["scheduler"]
        launch_gate(mode, sched.cfg, sched.decode_steps,
                    sched.prefill_chunks, counts, paged=sched.paged)
        progs = sched.step_programs()
        built = [progs["decode"], *next(v for k, v in progs.items()
                                        if k != "decode").values()]
        comps = res["completions"]
        vp = sched.params["embed"].shape[0]
        if len(comps) != 6 or any(
                len(c.tokens) != 16 or not all(0 <= t < vp for t in c.tokens)
                for c in comps.values()) \
                or any(n != 1 for n in built) \
                or res["graphs"] != len(built):
            raise AssertionError(f"moe {mode} {layout}: completions "
                                 f"{tokens_of(comps)}, programs {progs}, "
                                 f"{res['graphs']} graphs")
        log(f"moe {mode} {layout}: {sched.cfg.name} {sched.cfg.num_layers} "
            f"layers d_model {sched.cfg.d_model}, {sched.cfg.moe.num_experts} "
            f"experts top-{sched.cfg.moe.top_k}, capacity factor "
            f"{sched.cfg.moe.capacity_factor}; 6 requests x 16 tokens, "
            f"{sched.decode_steps} decode steps + {sched.prefill_chunks} "
            f"prefill {'chunks' if sched.paged else 'prompts'}; launches "
            f"{counts} (replays counted); programs {progs}, {res['graphs']} "
            f"graphs built in {res['build_s']:.2f} s; peak_mem_GB "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
        runs[layout] = dict(tokens=tokens_of(comps),
                            requests=res["requests"])
        if layout == "paged":
            runs[layout]["sched"] = sched
            del res, sched
            continue
        # one model on the card: the contiguous scheduler again on the
        # paged run's weights (the same seed, so the same weights)
        del res, sched, comps
        gc.collect()
        torch.cuda.empty_cache()
        p = runs["paged"]["sched"]
        runs[layout]["sched"] = ContinuousBatchingScheduler(
            p.cfg, p.params, num_slots=p.num_slots, max_len=p.max_len,
            kv_block_size=0, device=p.device)
    reqs = runs["paged"]["requests"]
    gates, again, eager = {}, {}, {}
    for layout, run in runs.items():
        sched = run["sched"]
        # the trace again from the state a fresh scheduler starts in (the
        # idle rows take capacity, so a run depends on what the last one
        # left in them)
        sched._reset()
        again[layout] = timed_run(sched, reqs)
        progs = sched.step_programs()
        sched._reset()
        twice = timed_run(sched, reqs)
        eager[layout] = timed_run(like(sched, cuda_graphs=False), reqs)
        gates[f"{layout}: the same trace from a fresh state gives the CLI's "
              f"tokens, twice, building nothing after its first"] = (
            again[layout]["tokens"] == run["tokens"] == twice["tokens"]
            and sched.step_programs() == progs and progs["decode"] == 1)
        gates[f"{layout}: graphs and eager give the same tokens and "
              f"launches"] = (eager[layout]["tokens"] == run["tokens"]
                              and eager[layout]["launches"]
                              == twice["launches"])
        for r in (again[layout], twice, eager[layout]):
            launch_gate(mode, sched.cfg, r["steps"], r["chunks"],
                        r["launches"], paged=sched.paged)
        bad = nonfinite(sched)
        gates[f"{layout}: every step's last logits finite"] = not bad
    paged, contig = runs["paged"]["sched"], runs["contiguous"]["sched"]
    failed = [k for k, ok in gates.items() if not ok]
    for layout in runs:
        log(f"moe {mode} {layout}: decode_ms_per_step graphs / eager "
            f"{again[layout]['decode_ms']:.3f} / "
            f"{eager[layout]['decode_ms']:.3f}, tokens_per_s "
            f"{again[layout]['tokens_per_s']:.2f} / "
            f"{eager[layout]['tokens_per_s']:.2f}, peak_mem_GB "
            f"{again[layout]['peak_gb']:.2f} on {smi}")
    log(f"moe {mode} at the own capacity factor: paged and contiguous "
        f"first differ at {first_difference(runs['paged']['tokens'], runs['contiguous']['tokens'])} "
        f"(their chunks and prompts drop differently; not a gate); gates "
        f"failed: {failed}")
    if failed:
        raise AssertionError(f"moe {mode}: {failed}")
    moe_backend_parity(paged)
    moe_measure(paged, contig, reqs, smi)
    # at E / k nothing is dropped: each row alone again, up to the float
    # rounding of the expert products, whose row count is the capacity
    nd = no_drop(paged.cfg)
    scheds = {
        "paged": ContinuousBatchingScheduler(
            nd, paged.params, num_slots=paged.num_slots,
            max_len=paged.max_len, kv_block_size=16, chunked_prefill=True,
            device=paged.device),
        "contiguous": ContinuousBatchingScheduler(
            nd, paged.params, num_slots=paged.num_slots,
            max_len=paged.max_len, kv_block_size=0, device=paged.device)}
    nd_tokens = {k: timed_run(s, reqs)["tokens"] for k, s in scheds.items()}
    tie, sens = moe_backend_parity(scheds["paged"])
    t1 = time.perf_counter()
    eng = scheds["paged"].engine
    solo = {r.rid: oracle_completion(eng, r) for r in reqs}
    solo_s = time.perf_counter() - t1
    ref, margins = solo_routing(eng, reqs, solo)
    failed = []
    for layout, s in scheds.items():
        res, bad = no_drop_runs(s, reqs, nd_tokens[layout], solo, ref,
                                margins, tie, sens)
        failed += [f"{layout}: {b}" for b in bad]
        log(f"moe {mode} no drops, {layout}, against each request alone "
            f"(routing held to its own, then free; by request: first "
            f"difference free / held, solo top-2 margin there, router "
            f"probabilities' max drift, routing choices that would differ "
            f"and the first three (position, layer, gap)): "
            f"{res['rows']}")
    nd_tokens["solo"] = solo
    diff = {r.rid: next((i for i, t in enumerate(zip(
        *(run[r.rid] for run in nd_tokens.values()))) if len(set(t)) > 1),
        None) for r in reqs}
    n = sum(len(t) for t in solo.values())
    agree = sum(len(solo[rid]) if i is None else i for rid, i in diff.items())
    every = np.concatenate([np.asarray(m) for m in margins.values()])
    gaps = k_gaps(np.stack([pr for by_layer in ref.values()
                            for pr, _ in by_layer.values()]), nd.moe.top_k)
    log(f"moe {mode} at capacity factor {nd.moe.capacity_factor} (no drops): "
        f"paged, contiguous and each request alone through generate_loop "
        f"(cuda backend, solo runs {solo_s:.1f} s) agree on {agree} of {n} "
        f"tokens before their first differences {diff}; near-tie "
        f"thresholds with the routing held (backend parity at this "
        f"factor): logits {tie:.4g}, router {sens:.3g}; the solo runs' "
        f"top-2 logit margins: median {float(np.median(every)):.4g}, "
        f"{100 * float((every <= tie).mean()):.1f} % of {every.size} within "
        f"{tie:.4g}; their router k-th to (k+1)-th gaps: median "
        f"{float(np.median(gaps)):.3g}, {100 * float((gaps <= sens).mean()):.1f}"
        f" % of {gaps.size} within {sens:.3g}; gates failed: {failed}")
    if failed:
        raise AssertionError(f"moe {mode} no-drop: {failed}")
    del runs, run, paged, contig, scheds, eng, sched, p, s
    gc.collect()
    torch.cuda.empty_cache()
    for k, v in static_phase(mode, smi, OLMOE_STATIC_ARGS,
                             temps=(0.0,)).items():
        launches[k] = launches.get(k, 0) + v
    gc.collect()
    torch.cuda.empty_cache()
    log(f"moe {mode}: phase in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB left allocated")
    return launches


def granite_run(smi: str) -> dict[str, int]:
    """granite-moe-1b-a400m at full width (24 layers, 32 experts top-8,
    GQA G = 2, head dim 64, tied embeddings) through the CLI, paged, in
    ``pum``: completions, launches, programs built once, the same trace
    from a fresh state the same tokens building nothing, logits finite;
    a decode replay's device ms."""
    import gc
    import torch
    from repro_torch.kernels import registry
    from repro_torch.launch import serve
    registry.reset_launches()
    res = serve.main(GRANITE_ARGS + ["--pum-mode", "pum"])
    torch.cuda.synchronize()
    launches = dict(registry.LAUNCHES)
    sched = res["scheduler"]
    cfg = sched.cfg
    launch_gate("pum", cfg, sched.decode_steps, sched.prefill_chunks,
                launches)
    first = tokens_of(res["completions"])
    progs = sched.step_programs()
    sched._reset()
    again = timed_run(sched, res["requests"])
    launch_gate("pum", cfg, again["steps"], again["chunks"],
                again["launches"])
    gates = {
        "6 requests x 16 tokens": len(first) == 6 and all(
            len(t) == 16 for t in first.values()),
        "each program built once, as a graph": all(
            n == 1 for n in [progs["decode"], *progs["chunk"].values()])
        and res["graphs"] == 1 + len(progs["chunk"]),
        "the same trace from a fresh state gives the same tokens, building "
        "nothing": again["tokens"] == first
        and sched.step_programs() == progs,
        "every step's last logits finite": not nonfinite(sched),
    }
    failed = [k for k, ok in gates.items() if not ok]
    replay_ms = step_device_ms(sched)
    log(f"moe {cfg.name} pum paged: {cfg.num_layers} layers d_model "
        f"{cfg.d_model}, {cfg.moe.num_experts} experts top-"
        f"{cfg.moe.top_k}; {again['steps']} decode steps + "
        f"{again['chunks']} chunks; launches {launches} (first run); "
        f"a decode replay {replay_ms:.4f} ms of device time, "
        f"decode_ms_per_step {again['decode_ms']:.3f}, tokens_per_s "
        f"{again['tokens_per_s']:.2f}, peak_mem_GB {again['peak_gb']:.2f}; "
        f"gates failed: {failed} on {smi}")
    if failed:
        raise AssertionError(f"granite: {failed}")
    del res, sched
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def moe_phase(smi: str) -> dict[str, int]:
    """Phase 11; returns each kernel's launches on its main paths."""
    import torch
    t0 = time.perf_counter()
    # the router's f32 matmul must not round its inputs to TF32
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the MoE router runs in "
                             "f32 (models/moe.py)")
    launches: dict[str, int] = {}
    for run in (lambda: moe_run("pum", smi), lambda: moe_run("int8", smi),
                lambda: granite_run(smi)):
        for k, v in run().items():
            launches[k] = launches.get(k, 0) + v
    log(f"moe: phase 11 in {time.perf_counter() - t0:.1f} s")
    return launches


def check_moe_kernels(dev, gpu_name: str) -> dict[str, list[dict]]:
    """Phase 3's checks at the MoE family's shapes: K1 and K2 at
    OLMoE-1B-7B's 2048 x 2048 projections (a decode step's M = 4 and a
    chunk's M = 16), K3 at both head layouts, K3's duplicate-trash
    store.  Returns their rows of the kernels line."""
    mvm = mvm_sweep(dev, OLMOE_MVM, OLMOE_LAYERS, "OLMoE-1B-7B",
                    sorted(STEP_ROWS))
    attn = check_attention(dev, gpu_name, layouts=MOE_HEADS)
    check_trash_store(dev)
    return {"bitslice_mvm_scaled": [c["K1"] for c in mvm],
            "bitslice_mvm": [c["K2"] for c in mvm],
            "paged_attention": attn}


KERNELS = {
    "bitslice_mvm_scaled": dict(
        route="cuda",
        source="src/repro_torch/kernels/bitslice_mvm/csrc/bitslice_mvm.cu",
        replaces="src/repro/kernels/bitslice_mvm/kernel.py:139"),
    "bitslice_mvm": dict(
        route="cuda",
        source="src/repro_torch/kernels/bitslice_mvm/csrc/bitslice_mvm.cu",
        replaces="src/repro/kernels/bitslice_mvm/kernel.py:98"),
    "paged_attention": dict(
        route="cuda",
        source="src/repro_torch/kernels/paged_attention/csrc/"
               "paged_attention.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:113"),
    "gf2_mvm": dict(
        route="cuda",
        source="src/repro_torch/kernels/gf2_mvm/csrc/gf2_mvm.cu",
        replaces="src/repro/kernels/gf2_mvm/kernel.py:41"),
    "gf2_mvm_packed": dict(
        route="cuda",
        source="src/repro_torch/kernels/gf2_mvm/csrc/gf2_mvm.cu",
        replaces="src/repro/kernels/gf2_mvm/kernel.py:41"),
}
# held against its plain version in phase 3 only: the AES rounds run the
# state-byte entry, and no other path calls K4's int8 entry
OFF_MAIN_PATH = {"gf2_mvm"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=["kernels", "cnn", "contiguous",
                                       "xlstm", "moe"], default=None)
    args = ap.parse_args(argv)

    start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the "
              "card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    # -- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    gpu_name = torch.cuda.get_device_name(0)
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    dev = torch.device("cuda", 0)

    # -- 2. build
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"build: {len(logs)} kernel sources in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    if args.only == "cnn":
        cnn_launches, cnn_rows = cnn_phase(dev, gpu_name, smi)
        log(json.dumps({"kernels": {"bitslice_mvm": {
            "launches": cnn_launches["bitslice_mvm"],
            "cnn_shapes": cnn_rows}}}))
        return 0

    if args.only == "contiguous":
        contig_launches, prefill_rows = contiguous_phase(dev, gpu_name, smi)
        log(json.dumps({"kernels": {"launches": contig_launches,
                                    "prefill_shape": prefill_rows}}))
        log(f"phase 9 done at {time.perf_counter() - start:.1f} s")
        return 0

    if args.only == "xlstm":
        cases = xlstm_rows(check_xlstm_mvm(dev))
        xlstm_launches = xlstm_phase(smi)
        log(json.dumps({"kernels": {"launches": xlstm_launches,
                                    "xlstm_shapes": cases}}))
        log(f"phase 10 done at {time.perf_counter() - start:.1f} s")
        return 0

    if args.only == "moe":
        cases = check_moe_kernels(dev, gpu_name)
        moe_launches = moe_phase(smi)
        log(json.dumps({"kernels": {"launches": moe_launches,
                                    "moe_shapes": cases}}))
        log(f"phase 11 done at {time.perf_counter() - start:.1f} s")
        return 0

    # -- 3. kernels
    rows = check_mvm(dev)
    for name, cases in xlstm_rows(check_xlstm_mvm(dev)).items():
        rows[name]["xlstm_shapes"] = cases
    rows["paged_attention"] = attention_row(check_attention(dev, gpu_name))
    for name, cases in check_moe_kernels(dev, gpu_name).items():
        rows[name]["moe_shapes"] = cases
    rows.update(check_gf2(dev, gpu_name))
    if args.only == "kernels":
        log(json.dumps({"kernels": rows}))
        return 0

    log(f"phases 1-3 done at {time.perf_counter() - start:.1f} s")
    launches, greedy = serve_phases(smi)
    log(f"phases 4-5b done at {time.perf_counter() - start:.1f} s")
    for k, v in aes_phase(dev, smi).items():
        launches[k] = launches.get(k, 0) + v
    log(f"phase 6 done at {time.perf_counter() - start:.1f} s")
    cnn_launches, rows["bitslice_mvm"]["cnn_shapes"] = cnn_phase(
        dev, gpu_name, smi)
    for k, v in cnn_launches.items():
        launches[k] = launches.get(k, 0) + v
    log(f"phase 7 done at {time.perf_counter() - start:.1f} s")
    for k, v in sampled_phase(greedy, smi).items():
        launches[k] = launches.get(k, 0) + v
    log(f"phase 8 done at {time.perf_counter() - start:.1f} s")
    contig_launches, prefill_rows = contiguous_phase(dev, gpu_name, smi)
    for k, v in contig_launches.items():
        launches[k] = launches.get(k, 0) + v
    for name, row in prefill_rows.items():
        rows[name]["prefill_shape"] = row
    log(f"phase 9 done at {time.perf_counter() - start:.1f} s")
    for k, v in xlstm_phase(smi).items():
        launches[k] = launches.get(k, 0) + v
    log(f"phase 10 done at {time.perf_counter() - start:.1f} s")
    for k, v in moe_phase(smi).items():
        launches[k] = launches.get(k, 0) + v
    log(f"phase 11 done at {time.perf_counter() - start:.1f} s")
    out = []
    for name, meta in KERNELS.items():
        n = launches.get(name, 0)
        main_path = name not in OFF_MAIN_PATH
        if main_path and n <= 0:
            raise AssertionError(f"{name} never launched on the main path")
        if not main_path and n:
            raise AssertionError(f"{name} launched {n} times on the main "
                                 f"path, which should not call it")
        out.append({"name": name, **meta, "launches": n,
                    "main_path": main_path, **rows[name]})
    log(json.dumps({"kernels": out}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
