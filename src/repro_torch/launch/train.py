"""Training launcher of the port, the JAX package's ``launch/train.py``
flag for flag, on the card by default:

``python -m repro_torch.launch.train --arch qwen2.5-3b --steps 200
--batch 8 --seq 128 [--reduced|--full] [--pum-mode int8]``

``--reduced`` (the default) trains the arch's miniature, ``--full`` its
published widths; ``--pum-mode int8`` or ``pum`` trains through the
quantised forward (on the card the ``bitslice_mvm`` kernel) with the
straight-through gradient (QAT).  ``--device cpu`` runs on the CPU.
Prints every ``--log-every``-th step's loss, rate, gradient norm and
time, then one JSON line (final loss, steps, stragglers).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

from repro_torch import configs
from repro_torch.config import PUMConfig, ShardingConfig, TrainConfig
from repro_torch.device import resolve_device
from repro_torch.ft import PreemptionHandler
from repro_torch.train.trainer import Trainer


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--schedule", default="")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--pum-mode", default="bf16",
                    choices=["bf16", "int8", "pum"])
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv: list[str] | None = None) -> dict:
    """Train; returns the trainer's result (params, optimiser state,
    history, last step, stragglers)."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = (configs.get_reduced if args.reduced else configs.get)(args.arch)
    if args.pum_mode != "bf16":
        cfg = cfg.replace(pum=PUMConfig(mode=args.pum_mode))
    schedule = args.schedule or ("wsd" if args.arch == "minicpm-2b"
                                 else "cosine")
    tcfg = TrainConfig(steps=args.steps, learning_rate=args.lr,
                       warmup_steps=max(args.steps // 20, 1),
                       schedule=schedule, microbatch=args.microbatch,
                       ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    scfg = ShardingConfig(grad_compress=args.grad_compress)
    print(f"train: arch={cfg.name} mode={cfg.pum.mode} layers="
          f"{cfg.num_layers} d_model={cfg.d_model} batch={args.batch} "
          f"seq={args.seq} device={dev.type}", flush=True)
    trainer = Trainer(cfg, tcfg, scfg, batch=args.batch, seq=args.seq,
                      preemption=PreemptionHandler(install=True),
                      device=dev)
    out = trainer.run()
    trainer.preemption.uninstall()
    for h in out["history"]:
        if h["step"] % args.log_every == 0 or h["step"] == args.steps - 1:
            print(f"step {h['step']:5d} loss {h['loss']:.4f} "
                  f"lr {h['lr']:.2e} gnorm {h['grad_norm']:.3f} "
                  f"dt {h['step_time_s'] * 1e3:.0f}ms")
    print(json.dumps({"final_loss": out["history"][-1]["loss"],
                      "steps": out["last_step"],
                      "stragglers": out["stragglers"]}), flush=True)
    return out


if __name__ == "__main__":
    main()
