"""Serving launcher of the port, on the card by default: the
continuous-batching scheduler over a synthetic trace, or a static batch.

``python -m repro_torch.launch.serve --arch qwen2.5-3b --batch-slots 4
--requests 6 --min-prompt-len 20 --prompt-len 64 --gen 16 --pum-mode pum
--kv-block-size 16 --chunked-prefill``

``--arch xlstm-350m`` serves the recurrent xLSTM stack the same way; it
has no KV to page, so its requests take 0 blocks of the pool and only
its prompts' chunking follows ``--kv-block-size``.

``--arch olmoe-1b-7b`` and ``--arch granite-moe-1b-a400m`` serve the
MoE family: attention through the MVM and paged-attention kernels, the
f32 router and the float experts (cast to bf16 on every call) beside
them, at the config's own capacity factor, whose drops couple the rows
of a step.

``--arch jamba-v0.1-52b`` serves the hybrid family: Mamba mixers (their
conv window and SSM state a slot, no KV) and one attention layer in 8,
dense MLPs and routed experts in turn.  Its 32 layers at full width hold
16 MoE layers of f32 expert stacks, 180 GB, more than one card has; the
card serves one 8-layer period, which keeps the whole layout, through
``main(argv, cfg=configs.get("jamba-v0.1-52b").replace(num_layers=8))``
(``chip_smoke.py``).  ``--reduced`` serves its miniature.

``--arch glm4-9b``, ``minicpm-2b`` and ``command-r-plus-104b`` serve
through the dense path (command-r-plus-104b's 64 layers do not fit one
card: the card serves a cut of its depth through ``main(argv,
cfg=...)``).  ``--arch llava-next-mistral-7b`` serves text alone and
``--arch whisper-tiny`` its decoder alone (no encoder frames), as the
reference's CLI does; the image prefix is reached through
``lm.forward(image_embeds=)`` and the audio path through
``ServeEngine.generate(encoder_frames=)``.

``--prefix-cache`` shares the pool blocks of full prompt prefixes
between requests (paged only) and prints its counters on a
``prefix-cache: {json}`` line; ``--shared-prefix-len N`` starts every
prompt of the trace with one common prefix of N tokens (a prompt no
longer than N is a slice of it), the traffic the cache serves.

``--speculate-k K`` drafts K tokens a slot a step (n-gram
prompt-lookahead self-speculation) and verifies them in one step; the
tokens are those of ``--speculate-k 0`` in every ``--pum-mode`` (an MoE
model's excepted: its drafts share the expert capacity), and a
``speculative: {json}`` line prints the acceptance counters (paged
only).

``--frontend`` serves the trace through the resilient front end
(``serve.frontend.ServeFrontend``) on a virtual clock: a bounded
admission queue (``--max-queue``, ``--policy fifo|priority|edf``), a
deadline a request (``--deadline-ms``), seeded fault injection
(``--chaos "seed=0,fault=0.05,victim=0.02"``), typed outcomes for
whatever is rejected, expired or failed.  It prints an ``outcomes:``
line and a ``metrics:`` line whose latencies are virtual-clock
milliseconds (``tick_dt`` of virtual time a pump), not times of the
device:

``python -m repro_torch.launch.serve --arch qwen2.5-3b --batch-slots 4
--requests 12 --min-prompt-len 20 --prompt-len 64 --gen 16
--kv-block-size 16 --chunked-prefill --frontend --workload poisson
--max-queue 6 --policy edf --deadline-ms 400 --chaos
"seed=0,fault=0.05,victim=0.02"``

``--workload poisson`` draws Poisson arrivals: 25 requests a second of
the front end's clock with ``--frontend``, else a mean gap of 2
scheduler steps; ``burst`` (the default) sends every request at once.

``--kv-block-size 0`` serves the trace from contiguous per-slot windows
instead of the paged pool.  ``--batch-slots 0`` serves one static batch
of ``--batch`` prompts of ``--prompt-len`` tokens through
``ServeEngine.generate``: a compiled prefill and one compiled decode step
replayed for every token, or with ``--loop`` one decode step per token
dispatched from Python; it prints the reference
CLI's line (``decode=scan|loop``, tokens, tok/s).

``--no-prepack`` serves the float weights of ``int8``/``pum`` as drawn,
quantised on every call (the raw-weight forwards: K2's unpacked entry
on the card), as the reference's ``--no-prepack`` does; the tokens are
those of the packed weights.

Weights are random, drawn on the device from ``--seed``; ``--reduced``
serves the arch's miniature (the CPU tests do, with ``--device cpu``).
``--pum-mode bf16`` serves the float weights unpacked.  ``--temperature``
is every request's temperature (0, the default, is greedy), each request
drawing from its own seed, as the reference's CLI serves its trace.  On
the card every compiled step runs as a CUDA graph replay
(``serve.compiled``).  The trace run prints its sampled share,
throughput and decode milliseconds per step on lines of their own,
beside the device it ran on.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from repro_torch import configs
from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serve import (ChaosPolicy, ContinuousBatchingScheduler,
                               ServeEngine, ServeFrontend, VirtualClock,
                               kv_pool, synthetic_workload)

# the front end's metrics line: virtual-clock ms (and tok/s of virtual
# time) under --frontend, the reference CLI's nine keys
FRONTEND_METRICS = ("serve.ttft_ms_p50", "serve.ttft_ms_p99",
                    "serve.itl_ms_p50", "serve.tok_per_s", "serve.shed",
                    "serve.rejected", "serve.expired", "serve.faults",
                    "serve.retries")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2.5-3b",
                    choices=configs.all_arch_ids())
    ap.add_argument("--reduced", action="store_true",
                    help="serve the arch's same-family miniature")
    ap.add_argument("--batch-slots", type=int, default=4,
                    help="decode slots of the scheduler (0: one static "
                         "batch through ServeEngine.generate)")
    ap.add_argument("--batch", type=int, default=4,
                    help="prompts of the static batch (--batch-slots 0)")
    ap.add_argument("--loop", action="store_true",
                    help="static batch: one decode step per token "
                         "instead of the compiled token loop")
    ap.add_argument("--requests", type=int, default=0,
                    help="trace length (default: 4x slots)")
    ap.add_argument("--min-prompt-len", type=int, default=1)
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="longest prompt of the trace")
    ap.add_argument("--gen", type=int, default=16,
                    help="tokens generated per request")
    ap.add_argument("--pum-mode", default="pum",
                    choices=["bf16", "int8", "pum"])
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="every request's sampling temperature (0: greedy)")
    ap.add_argument("--no-prepack", action="store_true",
                    help="skip load-time weight packing (per-call quant)")
    ap.add_argument("--kv-block-size", type=int, default=16,
                    help="tokens per KV block of the paged pool (0: "
                         "contiguous per-slot windows)")
    ap.add_argument("--num-kv-blocks", type=int, default=0,
                    help="pool size (default: slots * ceil(max_len / "
                         "block))")
    ap.add_argument("--chunked-prefill", action="store_true",
                    help="stream prompts in block-size chunks between "
                         "decode steps")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share full prompt-prefix blocks between "
                         "requests (content-hashed, refcounted, "
                         "copy-on-write at the boundary); requires "
                         "--kv-block-size")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="give every request of the trace this many "
                         "common leading prompt tokens (0: fully random "
                         "prompts)")
    ap.add_argument("--speculate-k", type=int, default=0,
                    help="speculative decoding: draft this many tokens "
                         "a slot a step (n-gram prompt-lookahead "
                         "self-speculation) and verify them in one "
                         "batched forward; the output stays that of "
                         "--speculate-k 0 in every --pum-mode (MoE "
                         "models excepted); requires --kv-block-size")
    ap.add_argument("--workload", default="burst",
                    choices=["burst", "poisson"],
                    help="arrivals of the trace: every request at once, or "
                         "Poisson (25 a second of the front end's clock "
                         "with --frontend, else a mean gap of 2 steps)")
    ap.add_argument("--frontend", action="store_true",
                    help="serve the trace through the resilient "
                         "ServeFrontend (admission queue, deadlines, "
                         "backpressure, typed outcomes) on a virtual "
                         "clock; requires --batch-slots")
    ap.add_argument("--max-queue", type=int, default=64,
                    help="bounded admission-queue depth for --frontend "
                         "(overflow is rejected, typed, never raised)")
    ap.add_argument("--policy", default="fifo",
                    choices=["fifo", "priority", "edf"],
                    help="admission-queue order for --frontend")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="every request's deadline for --frontend, in ms "
                         "of its clock: queued past it = expired, "
                         "decoding past it = cancelled with a truncated "
                         "partial")
    ap.add_argument("--chaos", default="",
                    help="fault-injection spec for --frontend, e.g. "
                         "'seed=0,fault=0.05,victim=0.02,stall=0.05,"
                         "latency_ms=40' (empty or 'off': none)")
    ap.add_argument("--kernel-backend", default="auto",
                    choices=["auto", "cuda", "torch"],
                    help="auto: the CUDA kernels on the card, the plain "
                         "PyTorch versions on the CPU")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and of the trace")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv: list[str] | None = None, *, cfg: ModelConfig | None = None
         ) -> dict:
    """Serve a trace (or, with ``--batch-slots 0``, a static batch);
    returns the scheduler (the engine), its completions (its tokens) and
    the measured numbers (for ``chip_smoke.py``); with ``--frontend``
    the front end, its results and its metrics snapshot in place of the
    completions.  ``cfg``,
    when given, is served in place of ``--arch``'s config (its mode from
    ``--pum-mode``, the rest of its ``PUMConfig`` as given): a caller's
    cut of a published config, such as Jamba's one period, or a config
    with ``pum.ibert``."""
    args = build_parser().parse_args(argv)
    if args.frontend and args.batch_slots <= 0:
        raise ValueError("--frontend serves through the scheduler; set "
                         "--batch-slots > 0")
    dev = resolve_device(args.device)
    if cfg is None:
        cfg = configs.get_reduced(args.arch) if args.reduced \
            else configs.get(args.arch)
    # the mode from --pum-mode; the rest of a given cfg's PUMConfig (say
    # ``ibert``) stays
    cfg = cfg.replace(pum=dataclasses.replace(cfg.pum, mode=args.pum_mode))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.perf_counter()
    # each layer packed as soon as it is drawn: the float tree never
    # lives whole on the card (glm4-9b's is 37.6 GB)
    prepack = not args.no_prepack
    params = lm.init_params(cfg, gen, device=dev, pack=prepack)
    max_len = args.prompt_len + args.gen + 1
    if args.batch_slots <= 0:
        return static_batch(cfg, params, args, dev, max_len)
    n = args.requests or 4 * args.batch_slots
    sched = ContinuousBatchingScheduler(
        cfg, params, num_slots=args.batch_slots, max_len=max_len,
        prepack=prepack,
        kv_block_size=args.kv_block_size, num_kv_blocks=args.num_kv_blocks,
        chunked_prefill=args.chunked_prefill,
        prefix_cache=args.prefix_cache, speculate_k=args.speculate_k,
        kernel_backend=None if args.kernel_backend == "auto"
        else args.kernel_backend, device=dev)
    del params
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    if args.frontend:
        return serve_frontend(sched, args, n, setup_s)
    reqs = synthetic_workload(n, cfg.vocab_size,
                              min_prompt=args.min_prompt_len,
                              max_prompt=args.prompt_len,
                              max_new=args.gen,
                              mean_interarrival=0.0
                              if args.workload == "burst" else 2.0,
                              temperature_choices=(args.temperature,),
                              shared_prefix_len=args.shared_prefix_len,
                              seed=args.seed)
    t0 = time.perf_counter()
    out = sched.run(reqs)
    wall_s = time.perf_counter() - t0
    toks = sum(len(c.tokens) for c in out.values())
    dev_name = device_name(dev)
    # host wall time from the start of a decode dispatch to the copy of
    # its outputs (a step's one-time build is not in it)
    decode_ms = 1e3 * sched.decode_seconds / max(1, sched.decode_steps)
    graphs, build_s = sched.graphs_captured()
    print(f"{summary(sched, args)} device={dev_name} "
          f"setup_s={setup_s:.2f}")
    print(f"served {len(out)} requests, {toks} tokens in {wall_s:.3f} s: "
          f"{sched.decode_steps} decode steps, {sched.prefill_chunks} "
          f"prefill {'chunks' if sched.paged else 'prompts'}; programs "
          f"{sched.step_programs()}, {graphs} CUDA graphs captured in "
          f"{build_s:.2f} s")
    sampled = sum(r.temperature > 0 for r in reqs) / len(reqs)
    print(f"sampled_share={sampled:.3f} (temperature {args.temperature}, "
          f"a seed a request)")
    print(f"throughput_tok_per_s={toks / wall_s:.2f}")
    print(f"decode_ms_per_step={decode_ms:.3f}")
    stats = sched.prefix_stats()
    if args.prefix_cache:
        print("prefix-cache:", json.dumps(stats))
    if args.speculate_k > 0:
        print("speculative:", json.dumps(sched.spec_stats()))
    return {"scheduler": sched, "requests": reqs, "completions": out,
            "tokens": toks, "wall_s": wall_s, "decode_ms": decode_ms,
            "setup_s": setup_s, "graphs": graphs, "build_s": build_s,
            "prefix_stats": stats, "spec_stats": sched.spec_stats()}


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def summary(sched, args) -> str:
    """The run's model, mode and KV layout, as the CLI's first line
    gives them."""
    cfg = sched.cfg
    chunked = (", chunked" if args.chunked_prefill else "") \
        + (", prefix-cache" if args.prefix_cache else "")
    blocks = (f"blocks={sched.num_kv_blocks}" if kv_pool.has_kv_cache(cfg)
              else "no KV: 0 blocks a request")
    kv = (f"paged(block={args.kv_block_size}, {blocks}{chunked})"
          if sched.paged else f"contiguous(max_len={sched.max_len})")
    return (f"arch={cfg.name} layers={cfg.num_layers} d_model={cfg.d_model} "
            f"mode={args.pum_mode} prepack={_prepacked(args)} "
            f"slots={args.batch_slots} kv={kv}")


def _prepacked(args) -> str:
    return "off" if args.no_prepack or args.pum_mode == "bf16" else "on"


def build_frontend(sched, args) -> ServeFrontend:
    """A front end over ``sched`` on a fresh virtual clock, with the
    CLI's queue, policy, deadline and chaos (each call a fresh chaos and
    retry generator: the same arguments replay the same storm)."""
    chaos = ChaosPolicy.parse(args.chaos) if args.chaos else None
    return ServeFrontend(
        sched, clock=VirtualClock(), max_queue=args.max_queue,
        policy=args.policy, default_deadline_ms=args.deadline_ms,
        chaos=chaos if chaos is not None and chaos.enabled else None)


def serve_frontend(sched, args, n: int, setup_s: float) -> dict:
    """Serve the trace through the resilient front end on a virtual
    clock, as the reference CLI does: overload and faults come back
    as typed outcomes, and the run ends with a metrics snapshot.  Its
    latencies are virtual-clock milliseconds, ``tick_dt`` a pump: a
    function of the trace, not a time of the device."""
    fe = build_frontend(sched, args)
    # Poisson arrivals at 25 requests a second of the front end's clock
    reqs = synthetic_workload(
        n, sched.cfg.vocab_size, min_prompt=args.min_prompt_len,
        max_prompt=args.prompt_len, max_new=args.gen,
        poisson_rate=0.0 if args.workload == "burst" else 25.0,
        temperature_choices=(args.temperature,),
        shared_prefix_len=args.shared_prefix_len, seed=args.seed)
    t0 = time.perf_counter()
    handles = fe.serve_trace(reqs)
    if sched.device.type == "cuda":
        torch.cuda.synchronize(sched.device)
    wall_s = time.perf_counter() - t0
    res = fe.results(handles)
    counts: dict[str, int] = {}
    for r in res.values():
        counts[r.status] = counts.get(r.status, 0) + 1
    toks = sum(len(r.tokens) for r in res.values())
    print(f"{summary(sched, args)} device={device_name(sched.device)} "
          f"setup_s={setup_s:.2f}")
    print(f"frontend(policy={args.policy}, queue={args.max_queue}"
          f"{', chaos' if fe.chaos is not None else ''}) served "
          f"{len(res)} requests ({toks} tokens) in {wall_s:.3f} s (wall, "
          f"builds included): {sched.decode_steps} decode steps, "
          f"{sched.prefill_chunks} prefill "
          f"{'chunks' if sched.paged else 'prompts'}; programs "
          f"{sched.step_programs()}")
    print("outcomes:", " ".join(f"{k}={v}"
                                for k, v in sorted(counts.items())))
    snap = fe.metrics.snapshot()
    print("metrics:", json.dumps({k: round(snap[k], 2)
                                  for k in FRONTEND_METRICS}),
          f"(virtual clock: ms and tok/s of {fe.cfg.tick_dt} s a pump, "
          f"not times of the device)")
    if args.prefix_cache:
        print("prefix-cache:", json.dumps(sched.prefix_stats()))
    return {"scheduler": sched, "requests": reqs, "frontend": fe,
            "handles": handles, "results": res, "snapshot": snap,
            "outcomes": counts, "tokens": toks, "wall_s": wall_s,
            "setup_s": setup_s, "args": args}


def static_batch(cfg, params, args, dev: torch.device, max_len: int) -> dict:
    """``--batch-slots 0``: one batch of ``--batch`` prompts of
    ``--prompt-len`` tokens, drawn from a ``torch.Generator`` seeded with
    ``--seed``, through ``ServeEngine.generate`` (the compiled token
    loop, or ``--loop``), timed build included, as the reference CLI
    times its first call."""
    eng = ServeEngine(cfg, params, max_len=max_len, prepack=False,
                      kernel_backend=None if args.kernel_backend == "auto"
                      else args.kernel_backend, device=dev,
                      use_scan=not args.loop)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=torch.Generator().manual_seed(
                               args.seed), dtype=torch.int32).to(dev)
    t0 = time.perf_counter()
    out = eng.generate(prompt, args.gen, temperature=args.temperature,
                       seed=args.seed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall_s = time.perf_counter() - t0
    toks = args.batch * args.gen
    dev_name = device_name(dev)
    print(f"arch={cfg.name} mode={args.pum_mode} "
          f"decode={'loop' if args.loop else 'scan'} "
          f"prepack={_prepacked(args)} device={dev_name} "
          f"generated {toks} tokens in {wall_s:.2f}s "
          f"({toks / wall_s:.1f} tok/s incl. build)")
    print("sample:", out[0, :32].tolist())
    return {"engine": eng, "prompt": prompt, "out": out, "tokens": toks,
            "wall_s": wall_s}


if __name__ == "__main__":
    main(sys.argv[1:])
