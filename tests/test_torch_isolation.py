"""The PyTorch port stands alone: ``repro_torch`` and ``chip_smoke`` import
with ``jax`` and ``repro`` made unimportable, and the port's entry points
refuse to run on the CPU unless the caller asks for it."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

BLOCKED_IMPORTS = r"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import importlib, pkgutil
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, sys.argv[1])
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro")
                and sys.modules[m] is not None)
assert not leaked, leaked
print(len(names))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_port_and_chip_smoke_import_without_jax():
    out = subprocess.run([sys.executable, "-c", BLOCKED_IMPORTS, str(ROOT)],
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 30      # every module was walked


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py copied into an otherwise empty directory cannot run
    (nothing of the port beside it) and exits nonzero with no result."""
    (tmp_path / "chip_smoke.py").write_bytes(
        (ROOT / "chip_smoke.py").read_bytes())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card refusals do not "
                    "apply")


def test_cuda_entry_points_raise_without_a_card(no_card):
    from repro_torch.bridge import arena_from_numpy, params_from_numpy
    from repro_torch.configs import reduced_config
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models.model import init_params
    from repro_torch.serve.engine import ServeEngine

    cfg = reduced_config("stablelm-1.6b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        arena_from_numpy({})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--requests", "1"])


def test_chip_smoke_refuses_without_a_card(no_card, capsys):
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out
