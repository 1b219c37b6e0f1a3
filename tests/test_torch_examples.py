"""The PyTorch port's examples (``examples/torch_*.py``) run on the CPU
with ``--device cpu``, each in a fresh process, and their asserts hold:
QMC drifts less than RTN-INT4 in the quickstart, the paged engine gives
the legacy engine's greedy tokens, the training loss falls and every
perplexity is finite, the chosen memory design fits its power budget.
Without ``--device cpu`` an example asks for the card, and refuses to run
where there is none."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = {
    "torch_quickstart.py": ([], "OK: QMC < RTN drift"),
    "torch_serve_quantized.py": ([], "OK: fp32 paged = fp32 legacy"),
    "torch_train_quantize_eval.py": (["--small", "--steps", "20"],
                                     "held-out perplexity"),
    "torch_codesign_dse.py": ([], "chosen: mram_channels="),
}


def _run(name, args, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, str(ROOT / "examples" / name),
                           *args], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name, tmp_path):
    args, marker = EXAMPLES[name]
    if name == "torch_train_quantize_eval.py":
        args = args + ["--ckpt-dir", str(tmp_path / "ckpt")]
    out = _run(name, args + ["--device", "cpu"], tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert marker in out.stdout


@pytest.mark.parametrize("name", ["torch_quickstart.py",
                                  "torch_serve_quantized.py"])
def test_example_asks_for_the_card(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    out = _run(name, [], tmp_path)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
