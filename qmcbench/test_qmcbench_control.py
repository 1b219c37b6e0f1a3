"""The control: the reference at the next precision below the
configuration's (TF32 products for float32 with TF32 off) in the
program's place must come out not correct, while the program comes out
correct, on the same prompts and served tokens.

At a small size on the CPU here; at each cell's own size, on three
seeds, on the card (``-m gpu``): one wave of the cell's traffic through
the engine as the window drives it, then the program's and the
control's readings of the run's sample, printed as one JSON line per
seed."""
import json

import pytest

from qmcbench import harness, spec, traffic
from qmcbench.smallcell import small_cell

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


def _readings(cell, seed, device):
    from repro_torch.obs.trace import Tracer
    harness.set_precision(cell.config)
    eng = harness.build_engine(cell, seed, device, Tracer(enabled=False))
    draws = traffic.wave(cell.traffic, cell.config["model"]["vocab"], seed,
                         0)
    reqs = harness.requests_of(draws)
    eng.run(reqs)
    del eng
    wave = harness.Wave(reqs, None, 0.0, False)
    sample = harness.check_sample([wave], seed,
                                  int(cell.traffic["check_tokens"]),
                                  int(cell.traffic["check_requests"]))
    return harness.compare(cell, seed, sample, device, control=True)


def _judge(cell, got):
    lim = cell.config["correct"]
    program_ok = all(got[k] <= lim[k] for k in harness.COMPARED)
    control_ok = all(got[f"control_{k}"] <= lim[k]
                     for k in harness.COMPARED)
    return program_ok, control_ok


@pytest.mark.parametrize("name", ["stablelm-1.6b.chat",
                                  "hymba-1.5b.chat-long"])
def test_control_fails_at_small_size(name):
    cell = small_cell(name)
    for seed in (1, 2, 3):
        program_ok, control_ok = _judge(cell, _readings(cell, seed, "cpu"))
        assert program_ok and not control_ok


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_cell_size(name, card):
    import torch
    cell = spec.load_cell(name)
    seeds = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)
    verdicts = []
    for seed in seeds:
        got = _readings(cell, seed, card)
        print(json.dumps({"cell": name, "seed": seed, **got}), flush=True)
        verdicts.append(_judge(cell, got))
        torch.cuda.empty_cache()
    assert all(p and not c for p, c in verdicts), verdicts
