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

``--kv-block-size 0`` serves the trace from contiguous per-slot windows
instead of the paged pool.  ``--batch-slots 0`` serves one static batch
of ``--batch`` prompts of ``--prompt-len`` tokens through
``ServeEngine.generate``: a compiled prefill and one compiled decode step
replayed for every token, or with ``--loop`` one decode step per token
dispatched from Python; it prints the reference
CLI's line (``decode=scan|loop``, tokens, tok/s).

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
import sys
import time

import torch

from repro_torch import configs
from repro_torch.config import PUMConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serve import (ContinuousBatchingScheduler, ServeEngine,
                               kv_pool, synthetic_workload)


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
    ap.add_argument("--kv-block-size", type=int, default=16,
                    help="tokens per KV block of the paged pool (0: "
                         "contiguous per-slot windows)")
    ap.add_argument("--num-kv-blocks", type=int, default=0,
                    help="pool size (default: slots * ceil(max_len / "
                         "block))")
    ap.add_argument("--chunked-prefill", action="store_true",
                    help="stream prompts in block-size chunks between "
                         "decode steps")
    ap.add_argument("--kernel-backend", default="auto",
                    choices=["auto", "cuda", "torch"],
                    help="auto: the CUDA kernels on the card, the plain "
                         "PyTorch versions on the CPU")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and of the trace")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv: list[str] | None = None) -> dict:
    """Serve a burst trace (or, with ``--batch-slots 0``, a static
    batch); returns the scheduler (the engine), its completions (its
    tokens) and the measured numbers (for ``chip_smoke.py``)."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = configs.get_reduced(args.arch) if args.reduced \
        else configs.get(args.arch)
    cfg = cfg.replace(pum=PUMConfig(mode=args.pum_mode))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.perf_counter()
    params = lm.prepack_for_serving(lm.init_params(cfg, gen, device=dev),
                                    cfg)
    max_len = args.prompt_len + args.gen + 1
    if args.batch_slots <= 0:
        return static_batch(cfg, params, args, dev, max_len)
    n = args.requests or 4 * args.batch_slots
    sched = ContinuousBatchingScheduler(
        cfg, params, num_slots=args.batch_slots, max_len=max_len,
        kv_block_size=args.kv_block_size, num_kv_blocks=args.num_kv_blocks,
        chunked_prefill=args.chunked_prefill,
        kernel_backend=None if args.kernel_backend == "auto"
        else args.kernel_backend, device=dev)
    del params
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    reqs = synthetic_workload(n, cfg.vocab_size,
                              min_prompt=args.min_prompt_len,
                              max_prompt=args.prompt_len,
                              max_new=args.gen,
                              temperature_choices=(args.temperature,),
                              seed=args.seed)
    t0 = time.perf_counter()
    out = sched.run(reqs)
    wall_s = time.perf_counter() - t0
    toks = sum(len(c.tokens) for c in out.values())
    dev_name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
    # host wall time from the start of a decode dispatch to the copy of
    # its outputs (a step's one-time build is not in it)
    decode_ms = 1e3 * sched.decode_seconds / max(1, sched.decode_steps)
    graphs, build_s = sched.graphs_captured()
    chunked = ", chunked" if args.chunked_prefill else ""
    blocks = (f"blocks={sched.num_kv_blocks}" if kv_pool.has_kv_cache(cfg)
              else "no KV: 0 blocks a request")
    kv = (f"paged(block={args.kv_block_size}, {blocks}{chunked})"
          if sched.paged else f"contiguous(max_len={max_len})")
    print(f"arch={cfg.name} layers={cfg.num_layers} d_model={cfg.d_model} "
          f"mode={args.pum_mode} slots={args.batch_slots} kv={kv} "
          f"device={dev_name} setup_s={setup_s:.2f}")
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
    return {"scheduler": sched, "requests": reqs, "completions": out,
            "tokens": toks, "wall_s": wall_s, "decode_ms": decode_ms,
            "setup_s": setup_s, "graphs": graphs, "build_s": build_s}


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
    dev_name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
    print(f"arch={cfg.name} mode={args.pum_mode} "
          f"decode={'loop' if args.loop else 'scan'} device={dev_name} "
          f"generated {toks} tokens in {wall_s:.2f}s "
          f"({toks / wall_s:.1f} tok/s incl. build)")
    print("sample:", out[0, :32].tolist())
    return {"engine": eng, "prompt": prompt, "out": out, "tokens": toks,
            "wall_s": wall_s}


if __name__ == "__main__":
    main(sys.argv[1:])
