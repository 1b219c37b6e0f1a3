"""Nothing the benchmark runs loads JAX, its libraries or the JAX package
``repro`` (top-level names compared whole: the port is ``repro_torch``),
the reference and the yardstick import nothing of the program, and the
entry point refuses to run without a card or without the program."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from qmcbench import run

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# a child process of a test worker: no PYTHONPATH (the run finds the port
# itself) and one thread, as the workers beside it each run torch
_ENV = dict({k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
            OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
STDLIB_OK = {"__future__", "bisect", "copy", "dataclasses", "math",
             "statistics", "typing"}


def _imports(path: Path):
    """Every module a file imports, ``from a import b`` as ``a.b``."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield from (f"{node.module}.{a.name}" for a in node.names)


def test_reference_and_yardstick_import_nothing_of_the_program():
    for name in ("reference.py", "refquant.py", "weights.py", "work.py",
                 "traffic.py", "rounds.py"):
        for mod in _imports(HERE / name):
            top = mod.split(".")[0]
            assert top in STDLIB_OK | {"torch", "numpy", "qmcbench"}, \
                (name, mod)
            if top == "qmcbench":
                assert mod.split(".")[1] in {"work", "weights", "refquant",
                                             "traffic", "spec"}, (name, mod)


def test_forbidden_names_compare_whole(monkeypatch):
    base = {k: v for k, v in sys.modules.items()
            if k.split(".")[0] not in run.FORBIDDEN}
    monkeypatch.setattr(sys, "modules", dict(
        base, **{"repro_torch": sys, "repro_torch.serve": sys,
                 "reprox": sys}))
    assert run.forbidden_modules() == []
    monkeypatch.setattr(sys, "modules", dict(
        base, **{"repro.models.config": sys, "jaxlib.xla": sys}))
    assert run.forbidden_modules() == ["jaxlib", "repro"]


def test_a_run_loads_no_jax():
    script = (
        "import sys, json, torch\n"
        "torch.set_num_threads(1)\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from qmcbench import harness, run\n"
        "from qmcbench.smallcell import small_cell\n"
        "r = harness.run_cell(small_cell('hymba-1.5b.chat-long'), 9, 0.5,"
        " False, device='cpu')\n"
        "print(json.dumps([r['correct'], run.forbidden_modules()]))\n")
    out = subprocess.run([sys.executable, "-c", script], env=_ENV,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, []]


def _entry(cwd: Path):
    return subprocess.run(
        [sys.executable, "qmcbench/run.py", "--workload",
         "stablelm-1.6b.chat", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=cwd, capture_output=True, text=True, timeout=240,
        env=_ENV)


def test_entry_refuses_without_a_card_or_the_program(tmp_path):
    import torch
    if torch.cuda.is_available():
        return                   # the card's runs cover the entry there
    out = _entry(ROOT)
    assert out.returncode == 2 and out.stdout == ""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "qmcbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _entry(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
