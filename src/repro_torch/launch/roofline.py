"""Roofline terms on the H100 (the counterpart of
``repro.launch.roofline``: the ``Roofline`` compute, memory and
collective terms, ``from_artifacts``, ``model_flops_for`` and
``useful_bytes_for``), and the work each serving kernel does, counted
from its shapes.

Peak rates: NVIDIA H100 Tensor Core GPU datasheet, dense rates without
sparsity, at the card's full power limit (datasheet figures, not
measurements):

  ============  =========  ==========  ==========  ==========  =========
  part          HBM        fp32 cores  TF32 dense  BF16 dense  NVLink
  ============  =========  ==========  ==========  ==========  =========
  H100 SXM5     3.35 TB/s  67 TFLOP/s  495         989         900 GB/s
  H100 PCIe     2.0 TB/s   51          378         756         600 GB/s
  H100 NVL      3.9 TB/s   60          417.5       835.5       600 GB/s
  ============  =========  ==========  ==========  ==========  =========

The NVLink column is the per-GPU total over both directions. Across
nodes, an NVIDIA DGX H100 node has one ConnectX-7 port at 400 Gb/s
(50 GB/s a direction) per GPU (DGX H100 datasheet). So the collective
term takes ``NVLINK_BW`` = 450 GB/s a direction for the bytes a rank
moves over ``model`` (inside a node: ``launch.mesh.
make_production_mesh``) and ``NET_BW`` = 50 GB/s for the rest (``data``,
``pod``, the whole grid), each a rank's payload over one direction of
its own links.

The serving terms use the SXM5 row (``HBM_BW``, ``TF32_FLOPS``), the
part this repository's card measurements were taken on; ``peaks``
picks a row by the card's name for the kernel bounds in
``chip_smoke.py``.

  compute    = FLOPs x tensor-core products / TF32 peak
  memory     = bytes / HBM bandwidth
  collective = intra-node bytes / NVLINK_BW + other bytes / NET_BW

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
cannot drift apart. There is no HLO to parse for collective bytes (the
reference's ``collective_bytes``): the dry run's ``launch.mesh.DryMesh``
tallies every collective a rank's step issues, by kind and by axis, and
that tally takes its place.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

# (name fragment, HBM bytes/s, fp32 FLOP/s outside the tensor cores, dense
# TF32 FLOP/s): the first fragment found in the card's name wins, so the
# SXM5 row, matched by "H100" alone, comes last
PEAKS = [("H100 PCIe", 2.0e12, 51e12, 378e12),
         ("H100 NVL", 3.9e12, 60e12, 417.5e12),
         ("H100", 3.35e12, 67e12, 495e12)]

_, HBM_BW, FP32_FLOPS, TF32_FLOPS = PEAKS[-1]
NVLINK_BW = 450e9        # bytes/s a direction, H100 SXM5 NVLink 4
NET_BW = 50e9            # bytes/s a direction, a DGX H100 GPU's 400 Gb/s


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
             experts: Sequence[Tuple[float, float]],
             router_experts: Optional[int] = None) -> Tuple[float, float]:
    """(bytes, FLOPs) of one MoE FFN over ``m`` token rows
    (``models/moe.py``): the router ``[m, d] @ [d, E]``; ``experts``, the
    (bytes, FLOPs) of each expert product at ``cap`` rows (E x 3 for a
    gated FFN, E x 2 otherwise; ``qmm_work`` at qmm's padded rows for a
    QTensor, ``matmul_work`` for a dense stack); the dispatch (x read,
    the ``[E, cap, d]`` buffer written) and the combine (the expert
    outputs and the ``[m, k]`` fp32 gates read, y written; a multiply
    and an add per contribution). The router scores ``router_experts``
    (default ``n_experts``: every expert of the layer, where a rank
    holds ``n_experts`` of them)."""
    nbytes, flops = matmul_work(m, d, router_experts or n_experts,
                                x_itemsize, router_itemsize)
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
    coll_bytes_per_dev: float = 0.0
    model_flops: float = 0.0      # 6*N_active*D for the step's tokens
    useful_bytes: float = 0.0     # irreducible weight+cache traffic
    coll_intra_bytes_per_dev: float = 0.0   # over NVLink, inside a node
    act_dtype: str = "float32"
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0

    def finalize(self) -> "Roofline":
        self.t_compute = self.flops_per_dev / peak_flops(self.act_dtype)
        self.t_memory = self.bytes_per_dev / HBM_BW
        inter = self.coll_bytes_per_dev - self.coll_intra_bytes_per_dev
        self.t_collective = (self.coll_intra_bytes_per_dev / NVLINK_BW
                             + inter / NET_BW)
        return self

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_dev * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_time(self) -> float:
        """Ideal overlapped execution: max of the three streams."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """Useful work time / bound time, as the reference scores it: the
        useful FLOPs' time at the compute peak or the irreducible bytes'
        time at the HBM bandwidth, whichever is larger, over the binding
        stream."""
        if self.roofline_time <= 0:
            return 0.0
        t_useful_c = (self.model_flops / self.chips) / peak_flops(
            self.act_dtype)
        t_useful_b = (self.useful_bytes / self.chips) / HBM_BW
        return max(t_useful_c, t_useful_b) / self.roofline_time

    @property
    def bw_fraction(self) -> float:
        """Irreducible bytes / counted bytes over the mesh."""
        total = self.bytes_per_dev * self.chips
        return self.useful_bytes / total if total else 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(bottleneck=self.bottleneck,
                 useful_flops_ratio=self.useful_flops_ratio,
                 roofline_time=self.roofline_time,
                 roofline_fraction=self.roofline_fraction,
                 bw_fraction=self.bw_fraction)
        return d


def model_flops_for(cfg, suite) -> float:
    """6*N_active*D with D = tokens processed by the step (the
    reference's)."""
    n = cfg.active_param_count()
    if suite.kind == "train":
        tokens = suite.global_batch * suite.seq_len
        return 6.0 * n * tokens
    if suite.kind == "prefill":
        tokens = suite.global_batch * suite.seq_len
        return 2.0 * n * tokens          # forward only
    tokens = suite.global_batch           # one token per sequence
    return 2.0 * n * tokens


def useful_bytes_for(cfg, suite, serve_weights: str = "fp16") -> float:
    """Irreducible global bytes for the step (the reference's): every
    active weight read once (packed bits when serving QMC) + the valid
    KV/SSM cache (decode) or activation residency floor (train/prefill:
    params + grads touched)."""
    from repro_torch.memsys.workload import kv_bits_per_step
    n = cfg.active_param_count()
    w_bits = n * (5.2 if serve_weights == "qtensor"
                  and suite.kind == "decode" else 16.0)
    if suite.kind == "train":
        # fwd + bwd touch params twice, grads once, opt state twice
        return (3 * w_bits + 2 * cfg.param_count() * 32) / 8.0
    if suite.kind == "prefill":
        return w_bits / 8.0
    cache_bits = kv_bits_per_step(cfg, suite.seq_len) * suite.global_batch
    return (w_bits + cache_bits) / 8.0


def from_artifacts(arch: str, shape: str, mesh_name: str, chips: int,
                   cost: Dict, coll: Optional[Dict] = None,
                   model_flops: float = 0.0, useful_bytes: float = 0.0,
                   act_dtype: str = "float32") -> Roofline:
    """A finalized :class:`Roofline` from a cost dict (``"flops"``,
    ``"bytes accessed"`` per device) and a collective dict (``"total"``
    payload bytes a device moves, ``"intra_node"`` the part over
    NVLink)."""
    coll = coll or {}
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_dev=float(cost.get("flops", 0.0)),
        bytes_per_dev=float(cost.get("bytes accessed", 0.0)),
        coll_bytes_per_dev=float(coll.get("total", 0.0)),
        coll_intra_bytes_per_dev=float(coll.get("intra_node", 0.0)),
        model_flops=model_flops, useful_bytes=useful_bytes,
        act_dtype=act_dtype).finalize()
