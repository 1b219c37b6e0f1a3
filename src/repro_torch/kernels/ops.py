"""The qmm dispatch point used by ``models.layers.matmul_any``
(counterpart of ``repro.kernels.ops``).

``qmm_plan`` keys the tiling on the flattened activation width M (= B*C
under the serving step), with the JAX plan's path names and padding rule:
M is right-padded to the next multiple of 8 and the result sliced back;
a padded M >= 128 that divides by 128 takes the column-strip kernel, any
other the decode-width kernel. Shapes the kernels cannot tile (K or N not
a multiple of 128, or a non-(8, 128) subtile) and ``use_kernels=False``
take the plain version, "ref".

``path_counts`` counts the calls of every path. On a CPU tensor every
path runs the plain version (the kernel wrappers take it there).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.core.qtensor import QTensor
from repro_torch.kernels.qmm import qmm_colstrip, qmm_decode
from repro_torch.kernels.ref import qmm_ref

path_counts: Dict[str, int] = {"decode": 0, "colstrip": 0, "ref": 0}


def reset_path_counts() -> None:
    for k in path_counts:
        path_counts[k] = 0


def qmm_plan(m: int, k: int, n: int, subtile, use_kernels: bool = True
             ) -> dict:
    """Pick the qmm lowering for an [m, k] @ [k, n] call: ``{"path",
    "pad_m"}`` with path "colstrip" | "decode" | "ref"."""
    tileable = (tuple(subtile) == (8, 128) and k % 128 == 0
                and n % 128 == 0)
    if not (use_kernels and tileable):
        return {"path": "ref", "pad_m": m}
    pad_m = -(-m // 8) * 8
    path = "colstrip" if pad_m >= 128 and pad_m % 128 == 0 else "decode"
    return {"path": path, "pad_m": pad_m}


def qmm(x: torch.Tensor, qt: QTensor, use_kernels: bool = True
        ) -> torch.Tensor:
    """x [..., K] @ dequant(qt) [K, N] with batch dims preserved."""
    lead = x.shape[:-1]
    k = x.shape[-1]
    n = qt.shape[1]
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    plan = qmm_plan(m, k, n, qt.subtile, use_kernels)
    path_counts[plan["path"]] += 1
    if plan["path"] == "ref":
        return qmm_ref(x2, qt).reshape(*lead, n)
    if plan["pad_m"] != m:
        x2 = F.pad(x2, (0, 0, 0, plan["pad_m"] - m))
    kernel = qmm_colstrip if plan["path"] == "colstrip" else qmm_decode
    y = kernel(x2.contiguous(), qt)
    return y[:m].reshape(*lead, n)
