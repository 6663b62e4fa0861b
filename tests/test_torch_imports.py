"""The port stands alone and never runs on the CPU unasked:

  * no file of ``src/repro_torch`` nor ``chip_smoke.py`` imports JAX or
    the JAX package (an AST scan, so comments and strings do not count);
  * every entry point called without ``device`` on a machine with no
    CUDA raises instead of running on the CPU;
  * the serving and AES CLIs run end to end when the CPU is asked for:
    the scheduler over paged blocks (with and without the prefix cache)
    or contiguous windows, the static batch, and the resilient front end
    under seeded chaos;
  * a trace of ``synthetic_workload`` at its defaults is the one the
    function gave before the front end's fields existed (pinned by the
    SHA-256 of its fields).
"""
import ast
import dataclasses
import hashlib
import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch import bridge
from repro_torch.apps import aes_app, encoder_app
from repro_torch.config import PUMConfig, TrainConfig
from repro_torch.core.prepack import PackedLinear
from repro_torch.core.hct import DarthPUMDevice
from repro_torch.launch import aes, serve, train
from repro_torch.models import lm
from repro_torch.serve import (ContinuousBatchingScheduler, ServeEngine,
                               oracle_completion)
from repro_torch.train import Trainer

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__"):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                                str):
                    roots.add(arg.value.split(".")[0])
    return roots


def test_port_imports_no_jax_and_no_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    names = {f.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for f in files[:-1]}
    assert names >= {"serve/errors.py", "serve/policies.py",
                     "serve/chaos.py", "serve/frontend.py",
                     "ft/__init__.py", "ft/monitor.py", "ft/preemption.py",
                     "optim/adamw.py", "optim/schedules.py",
                     "train/step.py", "train/trainer.py",
                     "ckpt/checkpoint.py", "data/synthetic.py",
                     "dist/compress.py", "launch/train.py", "tree.py",
                     "core/ibert.py", "apps/encoder_app.py"}
    for f in files:
        bad = _imported_roots(f) & set(FORBIDDEN)
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"


def _loads_no_jax(module: str) -> None:
    """``module`` brings neither JAX nor the JAX package into a fresh
    interpreter."""
    import subprocess
    import sys
    code = (f"import sys; import {module}; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}); print(bad); sys.exit(1 if bad else 0)")
    env = {**__import__("os").environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_spec_module_loads_no_jax():
    """``repro_torch.serve.spec`` (the drafters) brings neither JAX nor
    the JAX package into a fresh interpreter."""
    _loads_no_jax("repro_torch.serve.spec")


def test_train_modules_load_no_jax():
    """Nor does the training path: the launcher and all it imports (the
    trainer, step, optimiser, checkpoints, data and compression)."""
    _loads_no_jax("repro_torch.launch.train")


def test_encoder_modules_load_no_jax():
    """Nor do the encoder app and the I-BERT kernels."""
    _loads_no_jax("repro_torch.apps.encoder_app")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_the_cpu_unasked(no_cuda):
    cfg = configs.get_reduced("qwen2.5-3b").replace(
        pum=PUMConfig(mode="int8"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm.init_params(cfg, torch.Generator())
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ContinuousBatchingScheduler(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--reduced", "--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--reduced", "--requests", "1", "--frontend"])
    pt, key = np.zeros((2, 16), np.uint8), np.zeros(16, np.uint8)
    for entry in (aes_app.aes_encrypt, aes_app.aes_decrypt,
                  aes_app.aes_encrypt_dce):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry(pt, key)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DarthPUMDevice(n_hcts=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        aes.main(["--blocks", "256"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg, TrainConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        encoder_app.encoder_init(torch.Generator(), layers=1, d_model=8,
                                 d_ff=16, vocab=10)
    enc = encoder_app.encoder_init(torch.Generator(), layers=1, d_model=8,
                                   d_ff=16, vocab=10, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bridge.encoder_params_from_numpy(
            {"embed": enc["embed"].numpy(), "pos": enc["pos"].numpy(),
             "layers": []})


ARCHS = ["qwen2.5-3b", "xlstm-350m"]
# the MoE family's rows share the expert capacity, so its completions
# are not its solo oracle's (tests/test_torch_moe.py holds them)
CLI_ARCHS = ARCHS + ["olmoe-1b-7b", "granite-moe-1b-a400m",
                     "jamba-v0.1-52b", "glm4-9b", "minicpm-2b",
                     "command-r-plus-104b", "llava-next-mistral-7b",
                     "whisper-tiny"]


@pytest.mark.parametrize("arch", CLI_ARCHS)
@pytest.mark.parametrize("mode", ["pum", "int8", "bf16"])
def test_serve_cli_on_the_cpu_when_asked(mode, arch, capsys):
    res = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--pum-mode", mode,
                      "--batch-slots", "2", "--requests", "3",
                      "--min-prompt-len", "3", "--prompt-len", "9",
                      "--gen", "4", "--kv-block-size", "4",
                      "--chunked-prefill"])
    out = capsys.readouterr().out
    assert "throughput_tok_per_s=" in out and "decode_ms_per_step=" in out
    assert "device=cpu" in out
    # the recurrent stack pages no KV
    assert ("no KV: 0 blocks a request" in out) == (arch == "xlstm-350m")
    assert len(res["completions"]) == 3
    assert all(len(c.tokens) == 4 for c in res["completions"].values())
    sched = res["scheduler"]
    # every prompt of 3..9 tokens streams in ceil(len / 4) chunks
    assert sched.prefill_chunks == sum(-(-len(r.prompt) // 4)
                                       for r in res["requests"])


@pytest.mark.parametrize("layout", [["--kv-block-size", "4",
                                     "--chunked-prefill"],
                                    ["--kv-block-size", "0"],
                                    ["--batch-slots", "0"]],
                         ids=["paged", "contiguous", "static"])
def test_serve_cli_no_prepack(layout, capsys):
    """``--no-prepack`` serves the float weights quantised per call
    (``int8``): the same tokens as the prepacked default."""
    args = ["--reduced", "--device", "cpu", "--pum-mode", "int8",
            "--batch-slots", "2", "--requests", "3", "--prompt-len", "9",
            "--gen", "5"] + layout
    packed = serve.main(args)
    raw = serve.main(args + ["--no-prepack"])
    out = capsys.readouterr().out
    assert "prepack=on" in out and "prepack=off" in out
    if "out" in raw:
        assert torch.equal(raw["out"], packed["out"])
        params = raw["engine"].params
    else:
        assert {r: c.tokens for r, c in raw["completions"].items()} == \
            {r: c.tokens for r, c in packed["completions"].items()}
        params = raw["scheduler"].params
    assert not any(isinstance(w, PackedLinear)
                   for w in _leaves(params["blocks"]))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def test_serve_cli_samples_at_its_temperature(capsys):
    """``--temperature`` is every request's temperature, each request
    seeded: the completions equal their solo oracle's."""
    res = serve.main(["--reduced", "--device", "cpu", "--batch-slots", "2",
                      "--requests", "3", "--prompt-len", "7", "--gen", "5",
                      "--kv-block-size", "4", "--chunked-prefill",
                      "--temperature", "0.7"])
    assert "sampled_share=1.000" in capsys.readouterr().out
    reqs = res["requests"]
    assert {r.temperature for r in reqs} == {0.7}
    assert len({r.seed for r in reqs}) == 3
    for req in reqs:
        assert res["completions"][req.rid].tokens == oracle_completion(
            res["scheduler"].engine, req)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_prefix_cache(arch, capsys):
    """``--prefix-cache --shared-prefix-len 8``: the ``prefix-cache:``
    line shows hits, the result carries the same counters, and every
    completion equals its solo oracle."""
    res = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch-slots", "2", "--requests", "5",
                      "--min-prompt-len", "4", "--prompt-len", "12",
                      "--gen", "4", "--kv-block-size", "4",
                      "--chunked-prefill", "--prefix-cache",
                      "--shared-prefix-len", "8"])
    line = next(ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("prefix-cache: "))
    stats = json.loads(line[len("prefix-cache: "):])
    assert stats == res["prefix_stats"] and stats["hits"] > 0
    for req in res["requests"]:
        assert res["completions"][req.rid].tokens == oracle_completion(
            res["scheduler"].engine, req)


@pytest.mark.parametrize("arch", ARCHS + ["jamba-v0.1-52b"])
def test_serve_cli_speculate_k(arch, capsys):
    """``--speculate-k 3``: the ``speculative:`` line carries the
    scheduler's counters, and the completions are those of
    ``--speculate-k 0``; it needs the paged pool."""
    args = ["--arch", arch, "--reduced", "--device", "cpu",
            "--batch-slots", "2", "--requests", "3", "--min-prompt-len",
            "3", "--prompt-len", "9", "--gen", "6", "--kv-block-size", "4",
            "--chunked-prefill", "--temperature", "0.7"]
    plain = serve.main(args)
    res = serve.main(args + ["--speculate-k", "3"])
    line = next(ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("speculative: "))
    stats = json.loads(line[len("speculative: "):])
    assert stats == res["spec_stats"] and stats["steps"] > 0
    assert stats["emitted"] == 3 * 5
    assert {r: c.tokens for r, c in res["completions"].items()} == \
        {r: c.tokens for r, c in plain["completions"].items()}
    assert res["scheduler"].step_programs()["spec"] == 1
    with pytest.raises(ValueError, match="rolls rejected draft KV"):
        serve.main(args[:-5] + ["--kv-block-size", "0", "--speculate-k",
                                "3"])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_contiguous_windows(arch, capsys):
    """``--kv-block-size 0``: the contiguous scheduler, one prefill a
    request, each completion equal to its solo oracle; chunked prefill
    needs the paged pool."""
    args = ["--arch", arch, "--reduced", "--device", "cpu",
            "--batch-slots", "2",
            "--requests", "3", "--prompt-len", "9", "--gen", "4",
            "--kv-block-size", "0", "--temperature", "0.5"]
    res = serve.main(args)
    assert "kv=contiguous(max_len=14)" in capsys.readouterr().out
    sched = res["scheduler"]
    assert not sched.paged and sched.prefill_chunks == 3
    for req in res["requests"]:
        assert res["completions"][req.rid].tokens == oracle_completion(
            sched.engine, req)
    with pytest.raises(ValueError, match="set kv_block_size > 0"):
        serve.main(args + ["--chunked-prefill"])


@pytest.mark.parametrize("arch", CLI_ARCHS)
@pytest.mark.parametrize("temperature", ["0", "0.7"])
def test_serve_cli_static_batch(temperature, arch, capsys):
    """``--batch-slots 0``: the static batch through ``generate``, the
    compiled token loop and ``--loop`` giving the same tokens."""
    args = ["--arch", arch, "--reduced", "--device", "cpu",
            "--batch-slots", "0",
            "--batch", "3", "--prompt-len", "7", "--gen", "5",
            "--temperature", temperature]
    scan = serve.main(args)
    loop = serve.main(args + ["--loop"])
    out = capsys.readouterr().out
    assert "decode=scan" in out and "decode=loop" in out
    assert "generated 15 tokens" in out and "tok/s" in out
    assert scan["out"].shape == (3, 12)
    assert torch.equal(scan["out"], loop["out"])
    assert torch.equal(scan["out"][:, :7], scan["prompt"])
    assert scan["engine"].scan_programs() == {(3, 7, float(temperature)):
                                              1}
    assert loop["engine"].scan_programs() == {}


@pytest.mark.parametrize("layout", [["--kv-block-size", "4",
                                     "--chunked-prefill"],
                                    ["--kv-block-size", "0"]],
                         ids=["paged", "contiguous"])
def test_serve_cli_frontend_under_chaos(layout, capsys):
    """``--frontend --workload poisson --chaos ...``: every request
    resolves with a typed status, the ``outcomes:`` and ``metrics:``
    lines carry the results and the snapshot (virtual-clock ms), every
    ``ok`` completion equals its solo oracle, and the pool ends clean."""
    res = serve.main(["--reduced", "--device", "cpu", "--batch-slots", "2",
                      "--requests", "8", "--min-prompt-len", "2",
                      "--prompt-len", "9", "--gen", "5", "--frontend",
                      "--workload", "poisson", "--max-queue", "4",
                      "--policy", "edf", "--deadline-ms", "150",
                      "--chaos", "seed=0,fault=0.05,victim=0.02,chunk=0.1,"
                      "stall=0.05"] + layout)
    lines = capsys.readouterr().out.splitlines()
    outcomes = next(ln for ln in lines if ln.startswith("outcomes: "))
    counts = dict(kv.split("=") for kv in outcomes.split()[1:])
    assert {k: int(v) for k, v in counts.items()} == res["outcomes"]
    assert sum(res["outcomes"].values()) == 8 and res["outcomes"]["ok"] > 0
    metrics = next(ln for ln in lines if ln.startswith("metrics: "))
    snap, end = json.JSONDecoder().raw_decode(metrics[len("metrics: "):])
    assert list(snap) == list(serve.FRONTEND_METRICS)
    assert "virtual clock" in metrics[len("metrics: ") + end:]
    assert snap == {k: round(res["snapshot"][k], 2)
                    for k in serve.FRONTEND_METRICS}
    sched, reqs = res["scheduler"], res["requests"]
    assert all(r.arrival_time is not None and r.deadline_ms is None
               for r in reqs)
    assert sorted(res["results"]) == [r.rid for r in reqs]
    for r in reqs:
        out = res["results"][r.rid]
        assert out.status in ("ok", "expired", "rejected", "failed",
                              "cancelled")
        want = oracle_completion(sched.engine, r)
        if out.ok:
            assert out.tokens == want
        else:
            assert out.error is not None
            assert out.tokens == want[:len(out.tokens)]
    assert sched.in_flight() == [] and sched.num_free_slots == 2
    assert not sched.paged or sched._alloc.live_blocks == 0
    with pytest.raises(ValueError, match="--batch-slots > 0"):
        serve.main(["--reduced", "--device", "cpu", "--batch-slots", "0",
                    "--frontend"])


# SHA-256 of (prompt, max_tokens, temperature, eos_id, seed, arrival, rid)
# of each request, from the function before the front end's fields
DEFAULT_TRACES = [
    (dict(n_requests=6, vocab_size=151936, min_prompt=20, max_prompt=64,
          max_new=16, seed=0),
     "37892cd684496b94c98aec43516c9b075028a3706aa60971bd9435b9459700f4"),
    (dict(n_requests=5, vocab_size=256, min_prompt=4, max_prompt=12,
          max_new=4, shared_prefix_len=8, seed=0),
     "64499113f7a1f626a42ede92347ea2e9507b21505721bd09980c1afd7619b06d"),
    (dict(n_requests=4, vocab_size=1000, max_prompt=9, max_new=5,
          mean_interarrival=2.0, temperature_choices=(0.0, 0.7, 1.0),
          seed=3),
     "a1972c8ddec73cfdd90d7eef69815d8268a90eb2b902a557ece7f9a1ee99128a"),
]


@pytest.mark.parametrize("kw,digest", DEFAULT_TRACES,
                         ids=["serve-args", "shared-prefix", "interarrival"])
def test_synthetic_workload_default_traces_unchanged(kw, digest):
    from repro_torch.serve import synthetic_workload
    reqs = synthetic_workload(**kw)
    rows = [(list(r.prompt), r.max_tokens, r.temperature, r.eos_id, r.seed,
             r.arrival, r.rid) for r in reqs]
    assert hashlib.sha256(json.dumps(rows).encode()).hexdigest() == digest
    assert all(r.arrival_time is None and r.priority == 0
               and r.deadline_ms is None for r in reqs)
    # the front end's fields come after, and move none of the draws above
    more = synthetic_workload(**kw, priority_choices=(0, 3),
                              deadline_ms=50.0)
    assert [dataclasses.replace(r, priority=0, deadline_ms=None)
            for r in more] == reqs
    assert {r.priority for r in more} <= {0, 3}
    poisson = synthetic_workload(**kw, poisson_rate=25.0)
    times = [r.arrival_time for r in poisson]
    assert times == sorted(times) and times[0] > 0
    assert all(r.arrival == int(r.arrival_time) for r in poisson)


def test_aes_cli_on_the_cpu_when_asked(capsys):
    res = aes.main(["--device", "cpu", "--blocks", "256", "--key-bytes",
                    "32"])
    out = capsys.readouterr().out
    assert "device=cpu" in out and "MB/s" in out
    assert "DARTH speedup" in out and "NOR +" in out
    assert res["rounds"] == 14 and res["oracle_blocks"] == 256
    assert res["dce_blocks"] == 256
    assert res["oracle_ok"] and res["roundtrip_ok"] and res["dce_ok"]
    assert res["ct"].shape == (256, 16) and res["ct"].device.type == "cpu"
    # on the CPU the wrapper takes the plain version: no kernel launches
    assert res["encrypt_launches"] == res["decrypt_launches"] == 0
