"""Boundaries of the PyTorch port: it imports neither JAX nor the JAX
package, its CLI refuses to fall back to the CPU silently, and the CLI
runs end to end on the CPU when asked to."""

import ast
from pathlib import Path

import pytest
import torch

from repro_torch.launch import train as cli

ROOT = Path(__file__).resolve().parents[1]


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_and_no_reference_package():
    files = _port_files()
    assert len(files) > 15 and all(f.exists() for f in files)
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_cli_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(["--steps", "1"])
    assert cli.resolve_device("cpu").type == "cpu"


def test_cli_runs_smoke_config_on_cpu(capsys):
    hist = cli.main(["--device", "cpu", "--steps", "3", "--log-every", "1",
                     "--t0", "2", "--t1", "2"])
    assert [rec["step"] for rec in hist] == [1, 2, 3]
    for key in ("loss", "honest_loss", "caught_byz", "evicted_honest",
                "n_good", "grad_norm", "zeta_sq"):
        assert key in hist[-1], key
    assert "tinyllama-smoke/sign_flip/safeguard" in capsys.readouterr().out


@pytest.mark.parametrize("flag", [["--sketch"], ["--hetero-alpha", "0.5"],
                                  ["--ckpt-dir", "ckpt"]])
def test_cli_rejects_options_not_ported(flag):
    with pytest.raises(SystemExit, match="not ported"):
        cli.main(["--device", "cpu", "--steps", "1", *flag])
