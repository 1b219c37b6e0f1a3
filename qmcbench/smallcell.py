"""A cell of the benchmark cut to a size the CPU tests run in seconds:
the configuration's block pattern and features at width 128, two layer
groups and a vocabulary of 512, under a mix of the same shape with short
prompts and outputs. Only tests use it; no run of the benchmark does."""
from __future__ import annotations

import copy

from qmcbench import spec


def small_cell(name: str, **traffic) -> spec.Cell:
    cell = copy.deepcopy(spec.load_cell(name))
    m = cell.config["model"]
    kv = 4 if m["n_kv_heads"] == m["n_heads"] else 2
    m.update(n_layers=2 * len(m["pattern"]), d_model=128, n_heads=4,
             n_kv_heads=kv, head_dim=32, d_ff=256, vocab=512)
    if "d_state" in m:
        m.update(d_state=16, ssm_headdim=32)
    if "window" in m:
        m["window"] = 16
    t = cell.traffic
    t.update(slots=4, wave=6, chunk=32, max_len=128, check_tokens=40,
             check_requests=3)
    t["prompt"].update(median=24, min=4, max=64)
    t["output"].update(median=8, min=2, max=30)
    t.update(traffic)
    return cell
