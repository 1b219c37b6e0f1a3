"""Roofline terms on the H100 (the part of ``repro.launch.roofline`` that
``obs/costs.py`` needs: the ``Roofline`` compute and memory terms and
``from_artifacts``), and the work each serving kernel does, counted from
its shapes.

Peak rates: NVIDIA H100 Tensor Core GPU datasheet, dense rates without
sparsity, at the card's full power limit:

  ============  =========  ==========  ==========  ==========
  part          HBM        fp32 cores  TF32 dense  BF16 dense
  ============  =========  ==========  ==========  ==========
  H100 SXM5     3.35 TB/s  67 TFLOP/s  495         989
  H100 PCIe     2.0 TB/s   51          378         756
  H100 NVL      3.9 TB/s   60          417.5       835.5
  ============  =========  ==========  ==========  ==========

The serving terms use the SXM5 row (``HBM_BW``, ``TF32_FLOPS``), the
part this repository's card measurements were taken on; ``peaks``
picks a row by the card's name for the kernel bounds in
``chip_smoke.py``.

  compute    = FLOPs x tensor-core products / TF32 peak
  memory     = bytes / HBM bandwidth
  collective = 0 (one card; the sharded port is ``ROADMAP.md`` A12)

The compute peak follows the activation dtype the way the kernels run
their products: the QMC codes (at most 5 bits) and the KV pages are
exact in TF32, so a bf16 activation takes one TF32 product per k step
and an fp32 activation two (split hi + lo). The dense BF16 rate stands
in the table for reference only: no kernel of the port issues bf16
products.

The work functions (``qmm_work``, ``matmul_work``, ``attention_work``,
``ssd_work``, ``moe_work``) count each input read once and each output written once, and the
operations the function needs; ``chip_smoke.py``'s kernel bounds and
``obs/costs.py``'s per-width step count both call them, so the two
cannot drift apart. HLO collective parsing, ``model_flops_for`` and
``useful_bytes_for`` are not ported (``ROADMAP.md`` A13).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

# (name fragment, HBM bytes/s, fp32 FLOP/s outside the tensor cores, dense
# TF32 FLOP/s): the first fragment found in the card's name wins, so the
# SXM5 row, matched by "H100" alone, comes last
PEAKS = [("H100 PCIe", 2.0e12, 51e12, 378e12),
         ("H100 NVL", 3.9e12, 60e12, 417.5e12),
         ("H100", 3.35e12, 67e12, 495e12)]

_, HBM_BW, FP32_FLOPS, TF32_FLOPS = PEAKS[-1]


def peaks(name: str) -> Tuple[float, float, float, str, bool]:
    """``(HBM bytes/s, fp32 FLOP/s, TF32 FLOP/s, row name, matched)`` for a
    card's name; a name in no row gets the SXM5 figures with
    ``matched=False``."""
    for frag, bw, fl, tc in PEAKS:
        if frag in name:
            return bw, fl, tc, frag, True
    return HBM_BW, FP32_FLOPS, TF32_FLOPS, PEAKS[-1][0], False


def tensor_core_products(act_dtype: str) -> int:
    """TF32 products per k step: two for an fp32 activation, one for a
    16-bit one."""
    return 2 if act_dtype == "float32" else 1


def peak_flops(act_dtype: str) -> float:
    """Useful FLOP/s at the TF32 peak for this activation dtype."""
    return TF32_FLOPS / tensor_core_products(act_dtype)


# ---------------------------------------------------------------------------
# the work of each serving kernel, from its shapes
# ---------------------------------------------------------------------------
def qmm_work(m: int, k: int, n: int, x_itemsize: int,
             subtile: Tuple[int, int] = (8, 128)) -> Tuple[float, float]:
    """(bytes, FLOPs) of ``y [m, n] = x [m, k] @ W`` over a QTensor as the
    port stores it: one int8 code per weight, a stream position (int32)
    and an outlier tag (one byte) per subtile, two fp32 scales per
    column; x read and y written in the activation dtype. ``m`` is the
    row count the kernel runs (padded to 8 by ``kernels.ops.qmm``)."""
    n_sub = (k // subtile[0]) * (n // subtile[1])
    codes = k * n + n_sub * 5 + 2 * n * 4
    return (m * k * x_itemsize + codes + m * n * x_itemsize,
            2.0 * m * k * n)


def matmul_work(m: int, k: int, n: int, x_itemsize: int, w_itemsize: int
                ) -> Tuple[float, float]:
    """(bytes, FLOPs) of ``x [m, k] @ w [k, n]`` with a dense weight."""
    return (m * k * x_itemsize + k * n * w_itemsize + m * n * x_itemsize,
            2.0 * m * k * n)


def attention_work(*, lanes: int, s: int, n_heads: int, n_kv: int,
                   hd: int, page: int, pages: int, keys: int,
                   tbl_entries: int, q_itemsize: int, kv_itemsize: int,
                   kv_scaled: bool) -> Tuple[float, float]:
    """(bytes, FLOPs) of one ragged paged-attention call: q ``[lanes, s,
    n_heads, hd]`` read, o written in fp32 with its softmax state (m, l),
    K and V of ``pages`` pages (and their bf16 scales on int8 pages), the
    block table (``tbl_entries`` int32) and the per-lane q_start and
    kv_len; ``keys`` is the number of (query, key) score entries
    computed, summed over lanes and queries, each costing QK and PV
    (4 hd FLOPs per head)."""
    q_el = lanes * s * n_heads * hd
    nbytes = q_el * (q_itemsize + 4) + 2 * lanes * s * n_heads * 4
    nbytes += 2 * pages * page * n_kv * hd * kv_itemsize
    if kv_scaled:
        nbytes += 2 * pages * page * n_kv * 2
    nbytes += tbl_entries * 4 + 2 * lanes * 4
    return nbytes, 4.0 * hd * n_heads * keys


def moe_work(*, m: int, cap: int, d: int, n_experts: int, topk: int,
             x_itemsize: int, router_itemsize: int,
             experts: Sequence[Tuple[float, float]]) -> Tuple[float, float]:
    """(bytes, FLOPs) of one MoE FFN over ``m`` token rows
    (``models/moe.py``): the router ``[m, d] @ [d, E]``; ``experts``, the
    (bytes, FLOPs) of each expert product at ``cap`` rows (E x 3 for a
    gated FFN, E x 2 otherwise; ``qmm_work`` at qmm's padded rows for a
    QTensor, ``matmul_work`` for a dense stack); the dispatch (x read,
    the ``[E, cap, d]`` buffer written) and the combine (the expert
    outputs and the ``[m, k]`` fp32 gates read, y written; a multiply
    and an add per contribution)."""
    nbytes, flops = matmul_work(m, d, n_experts, x_itemsize,
                                router_itemsize)
    for b, f in experts:
        nbytes += b
        flops += f
    buf = n_experts * cap * d * x_itemsize
    nbytes += (m * d * x_itemsize + buf) + (buf + m * topk * 4
                                            + m * d * x_itemsize)
    return nbytes, flops + 2.0 * m * topk * d


def ssd_work(*, lanes: int, s: int, chunk: int, heads: int, headdim: int,
             d_state: int, conv_rows: int, conv_dim: int,
             conv_itemsize: int) -> Tuple[float, float]:
    """(bytes, FLOPs) of one Mamba2 mixer's state update and scan over
    ``lanes`` lanes of ``s`` tokens, between its two projections: each
    lane's fp32 ``ssm`` state ``[heads, headdim, d_state]`` and its conv
    rows ``[conv_rows, conv_dim]`` read and written once; at s = 1 the
    recurrence (5 FLOPs per state element: decay, outer product, add, and
    the read-out's multiply-add), above it the chunked scan at ``chunk``
    (``models/ssm.py:chunk_for``), per chunk of L padded tokens and head
    the scores (C B^T, 2 L^2 N), the masked product with x (2 L^2 P), the
    incoming state's read-out and the state update (2 L N P each)."""
    state = heads * headdim * d_state
    nbytes = lanes * (2 * state * 4 + 2 * conv_rows * conv_dim
                      * conv_itemsize)
    if s == 1:
        return nbytes, 5.0 * lanes * state
    n_chunks = -(-s // chunk)
    per_chunk = 2.0 * heads * chunk * (chunk * (d_state + headdim)
                                       + 2 * d_state * headdim)
    return nbytes, lanes * n_chunks * per_chunk


# ---------------------------------------------------------------------------
# roofline terms
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_dev: float
    bytes_per_dev: float
    act_dtype: str = "float32"
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0

    def finalize(self) -> "Roofline":
        self.t_compute = self.flops_per_dev / peak_flops(self.act_dtype)
        self.t_memory = self.bytes_per_dev / HBM_BW
        self.t_collective = 0.0
        return self

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def roofline_time(self) -> float:
        """Ideal overlapped execution: max of the three streams."""
        return max(self.t_compute, self.t_memory, self.t_collective)


def from_artifacts(arch: str, shape: str, mesh_name: str, chips: int,
                   cost: Dict, act_dtype: str = "float32") -> Roofline:
    """A finalized :class:`Roofline` from a cost dict (``"flops"``,
    ``"bytes accessed"`` per device)."""
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_dev=float(cost.get("flops", 0.0)),
        bytes_per_dev=float(cost.get("bytes accessed", 0.0)),
        act_dtype=act_dtype).finalize()
