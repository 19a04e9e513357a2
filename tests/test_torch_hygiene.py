"""Boundaries of the port: it never imports jax, ml_dtypes or the reference
package, its entry point runs on the card unless asked for the CPU, and
its smoke script refuses to report a result without a card or without the
checkout.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> list[str]:
    mods = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module or "")
    return mods


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "ml_dtypes", "repro"), \
            f"{path}: {mod}"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_the_entry_point_loads_no_jax():
    code = ("import sys, repro_torch.launch.serve, repro_torch.kernels, "
            "repro_torch.launch.train, repro_torch.convert, repro_torch.train; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'ml_dtypes', 'repro')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], env=_env(), check=True,
                   timeout=120)


def test_entry_point_needs_cuda_unless_cpu_is_asked(capsys):
    from repro_torch.launch import serve
    argv = ["--arch", "dlrm-m1", "--smoke", "--requests", "8"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            serve.main(argv)
    engine = serve.main(argv + ["--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("serve[dlrm]: served=8 shed=0 degraded=0 ")
    assert engine.state.cache.device.type == "cpu"
    assert engine.metrics.batches >= 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            serve.main(argv + ["--chaos"])


def test_resolve_device_switches_tf32_off_on_cuda():
    from repro_torch import resolve_device
    assert resolve_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device(None)
        return
    resolve_device("cuda")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_chip_smoke_refuses_without_a_card_or_the_checkout(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the script would run")
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for cwd in (ROOT, tmp_path):
        p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                           env={k: v for k, v in os.environ.items()
                                if k != "PYTHONPATH"},
                           capture_output=True, text=True, timeout=120)
        assert p.returncode != 0
        assert '"ok"' not in p.stdout
