"""The port stands alone and never runs on the CPU unasked:

  * no file of ``src/repro_torch`` nor ``chip_smoke.py`` imports JAX or
    the JAX package (an AST scan, so comments and strings do not count);
  * every entry point called without ``device`` on a machine with no
    CUDA raises instead of running on the CPU;
  * the serving and AES CLIs run end to end when the CPU is asked for:
    the scheduler over paged blocks or contiguous windows, and the
    static batch.
"""
import ast
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.apps import aes_app
from repro_torch.config import PUMConfig
from repro_torch.core.hct import DarthPUMDevice
from repro_torch.launch import aes, serve
from repro_torch.models import lm
from repro_torch.serve import (ContinuousBatchingScheduler, ServeEngine,
                               oracle_completion)

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
    for f in files:
        bad = _imported_roots(f) & set(FORBIDDEN)
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"


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
    pt, key = np.zeros((2, 16), np.uint8), np.zeros(16, np.uint8)
    for entry in (aes_app.aes_encrypt, aes_app.aes_decrypt,
                  aes_app.aes_encrypt_dce):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry(pt, key)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DarthPUMDevice(n_hcts=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        aes.main(["--blocks", "256"])


ARCHS = ["qwen2.5-3b", "xlstm-350m"]
# the MoE family's rows share the expert capacity, so its completions
# are not its solo oracle's (tests/test_torch_moe.py holds them)
CLI_ARCHS = ARCHS + ["olmoe-1b-7b", "granite-moe-1b-a400m"]


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
