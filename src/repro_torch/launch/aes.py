"""AES launcher of the port: bulk encryption on the DARTH-PUM mapping
(paper §5.3) through K4's state-byte entry, checked against the numpy
oracle, the gate-accurate DCE path's gate count, and the cost model's
chip-level projection.  On the card by default.

``python -m repro_torch.launch.aes --blocks 16777216 --key-bytes 16``

Checks the ciphertext of 65 536 evenly strided blocks against the numpy
oracle, every block's round trip, and 256 blocks through the DCE path.

Plaintext and key are random, drawn from ``--seed``.  Prints the bulk
rates beside the device they ran on (on the card: the name and power
limit ``nvidia-smi`` gives).
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch.apps import aes_app
from repro_torch.core import costmodel as cm
from repro_torch.core.digital import GateCounter
from repro_torch.device import resolve_device
from repro_torch.kernels import registry
from repro_torch.kernels.gf2_mvm import ops as gf2

CHECK_BLOCKS = 65536   # evenly strided blocks held against the numpy oracle
DCE_BLOCKS = 256       # blocks through the gate-accurate DCE path


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks", type=int, default=1 << 24,
                    help="16-byte blocks encrypted in one bulk call")
    ap.add_argument("--key-bytes", type=int, default=16,
                    choices=[16, 24, 32], help="AES-128, -192 or -256")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap


def device_label(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    ``cpu``."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "-i", str(dev.index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(fn, dev: torch.device):
    """(result, seconds, launches of K4's state-byte entry) of one call."""
    _sync(dev)
    before = registry.LAUNCHES[gf2.PACKED_NAME]
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return (out, time.perf_counter() - t0,
            registry.LAUNCHES[gf2.PACKED_NAME] - before)


def main(argv: list[str] | None = None) -> dict:
    """Encrypt, check and project; returns the inputs, outputs and the
    measured numbers (for ``chip_smoke.py``)."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    label = device_label(dev)
    rng = np.random.default_rng(args.seed)
    key = rng.integers(0, 256, size=(args.key_bytes,), dtype=np.uint8)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    pt = torch.randint(0, 256, (args.blocks, 16), generator=gen, device=dev,
                       dtype=torch.uint8)
    rounds = aes_app.key_expansion(key).shape[0] - 1

    # warm-up: loads the kernel and the allocator's pools
    aes_app.aes_decrypt(aes_app.aes_encrypt(pt[:256], key, use_kernel=True,
                                            device=dev),
                        key, use_kernel=True, device=dev)
    ct, enc_s, enc_launches = _timed(lambda: aes_app.aes_encrypt(
        pt, key, use_kernel=True, device=dev), dev)
    back, dec_s, dec_launches = _timed(lambda: aes_app.aes_decrypt(
        ct, key, use_kernel=True, device=dev), dev)
    mb = args.blocks * 16 / 1e6
    roundtrip = bool(torch.equal(back, pt))

    stride = max(1, args.blocks // CHECK_BLOCKS)
    idx = torch.arange(0, args.blocks, stride, device=dev)
    want = aes_app.aes_encrypt_np(pt[idx].cpu().numpy(), key)
    oracle = bool(np.array_equal(ct[idx].cpu().numpy(), want))

    ctr = GateCounter()
    n_dce = min(DCE_BLOCKS, args.blocks)
    dce = aes_app.aes_encrypt_dce(pt[:n_dce].cpu().numpy(), key, ctr,
                                  device=dev)
    dce_equal = bool(np.array_equal(dce, ct[:n_dce].cpu().numpy()))

    print(f"AES-{8 * args.key_bytes}: {args.blocks} blocks ({mb:.1f} MB), "
          f"{rounds} rounds, {gf2.PACKED_NAME} launches encrypt "
          f"{enc_launches} decrypt {dec_launches}, device={label}")
    print(f"bulk encrypt {mb / enc_s:.1f} MB/s ({enc_s * 1e3:.3f} ms), "
          f"decrypt {mb / dec_s:.1f} MB/s ({dec_s * 1e3:.3f} ms) on "
          f"{label}")
    print(f"checks: oracle on {idx.numel()} strided blocks {oracle}, "
          f"decrypt(encrypt(x)) == x on every block {roundtrip}, DCE path "
          f"on {n_dce} blocks equal {dce_equal}")
    print(f"gate-accurate DCE path: {ctr.nor} NOR + {ctr.copy} copy "
          f"primitives for {n_dce} blocks")
    # chip-level projection (cost model, paper Fig 13/17)
    darth = {adc: cm.DarthPUM(adc).aes() for adc in ("sar", "ramp")}
    for adc, r in darth.items():
        print(f"DARTH-PUM ({adc}): {r.throughput * 16 / 1e9:7.1f} GB/s "
              f"chip throughput, {r.energy_j * 1e9:.2f} nJ/block (model)")
    b = cm.BaselineCPUAnalog().aes()
    print(f"Baseline (CPU+analog): {b.throughput * 16 / 1e9:7.2f} GB/s "
          f"-> DARTH speedup {darth['sar'].speedup_over(b):.1f}x "
          f"(paper: 59.4x) (model)")
    if not (oracle and roundtrip and dce_equal):
        raise RuntimeError(f"AES checks failed: oracle {oracle}, round trip "
                           f"{roundtrip}, DCE path {dce_equal}")
    return {"key": key, "pt": pt, "ct": ct, "back": back, "rounds": rounds,
            "encrypt_s": enc_s, "decrypt_s": dec_s,
            "encrypt_mb_per_s": mb / enc_s, "decrypt_mb_per_s": mb / dec_s,
            "encrypt_launches": enc_launches,
            "decrypt_launches": dec_launches, "oracle_ok": oracle,
            "oracle_blocks": idx.numel(), "roundtrip_ok": roundtrip,
            "dce_ok": dce_equal, "dce_blocks": n_dce, "gates": ctr,
            "device": label}


if __name__ == "__main__":
    main(sys.argv[1:])
