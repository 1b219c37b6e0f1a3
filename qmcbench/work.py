"""The yardstick: the chip's peaks and what a call or a step needs, in
operations and bytes, counted from shapes alone. Frozen here so that no
change to the program can move it.

* Peaks: NVIDIA's H100 SXM data sheet, dense rates: 989 TFLOP/s (bf16
  tensor cores) and 3.35 TB/s of HBM. No product that holds the
  configuration's float32 runs faster than one tensor-core product per
  multiply-add at the bf16 rate, so that rate is a floor on time.
* A call's least time is the larger of its operations over the peak rate
  and its bytes over the peak bandwidth, each input read once and each
  output written once.
* QMC weights count at the format's own bits: the inlier subtiles at
  ``bits_in``, the ``round(rho * n)`` outlier subtiles at ``bits_out``
  (3.6 bits a weight at rho 0.3), two fp32 scales per output column and
  one tag bit per subtile; not at the byte per code the port stores.
* KV pages count at the configuration's dtype, only the pages that hold
  the positions a lane's queries read: from the page of the window's
  first position (of the lane's first query) on windowed layers, from
  the first page otherwise, to the page of its last position.
* Activations count at their dtype (fp32)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Tuple

PEAK_FLOPS = 989e12        # H100 SXM, dense bf16
PEAK_BYTES = 3.35e12       # H100 SXM, HBM3
F32 = 4


def least_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def width_ladder(chunk: int) -> Tuple[int, ...]:
    """The step widths ``C > 1`` (a frozen copy of the program's rule):
    powers of two from 4 below ``chunk``, then ``chunk``."""
    if chunk <= 1:
        return ()
    w, out = 4, []
    while w < chunk:
        out.append(w)
        w *= 2
    out.append(chunk)
    return tuple(out)


def step_width(widest_grant: int, chunk: int) -> int:
    """The width a round runs at: 1 for pure decode, else the smallest
    rung covering its widest grant."""
    if widest_grant <= 1:
        return 1
    return min([w for w in width_ladder(chunk) if w >= widest_grant]
               or [chunk])


def qmm_route(m: int, k: int, n: int) -> Tuple[str, int]:
    """(route, padded rows) of a quantized [m, k] @ [k, n] product (a
    frozen copy of the program's plan): ``ref`` (no kernel) where k or n
    is not a multiple of 128; else rows padded to 8, and 128 or more
    that divide by 128 take the column strip (B3, rows padded to 128),
    any other the decode width (B2)."""
    if k % 128 or n % 128:
        return "ref", m
    g = -(-m // 8) * 8
    if g >= 128 and g % 128 == 0:
        return "colstrip", -(-m // 128) * 128
    return "decode", g


@dataclasses.dataclass(frozen=True)
class Proj:
    """One [K, N] matrix product of a step, ``calls`` times (the layers
    that hold it); ``head`` marks the output head, whose rows a step
    needs only where a token is emitted."""
    k: int
    n: int
    calls: int
    quantized: bool
    head: bool = False


def qmc_bytes(k: int, n: int, q: dict) -> float:
    """Bytes of a [k, n] weight in QMC's format."""
    r, c = q["subtile"]
    n_sub = (k // r) * (n // c)
    n_out = int(round(q["rho"] * n_sub))
    bits = ((n_sub - n_out) * q["bits_in"] + n_out * q["bits_out"]) * r * c
    return bits / 8 + 2 * n * F32 + n_sub / 8


def qmm_call(m: int, p: Proj, q: dict) -> Tuple[float, float]:
    """(operations, bytes) of one quantized product on ``m`` rows."""
    flops = 2.0 * m * p.k * p.n
    nbytes = qmc_bytes(p.k, p.n, q) + m * (p.k + p.n) * F32
    return flops, nbytes


@dataclasses.dataclass(frozen=True)
class Lane:
    """One live lane of a round: ``n`` new tokens at positions ``q0 ...
    q0 + n - 1``, reading keys up to its last one."""
    q0: int
    n: int


def _pages(lo: int, hi: int, page: int) -> int:
    """Pages holding positions ``lo ... hi - 1``."""
    return (hi - 1) // page - lo // page + 1


def _keys(q0: int, n: int, window) -> int:
    """Sum over the queries at ``q0 ... q0 + n - 1`` of the keys each
    reads: ``p + 1``, or ``min(p + 1, window)``."""
    a, b = q0 + 1, q0 + n

    def upto(x):                       # 1 + 2 + ... + x
        return x * (x + 1) // 2
    if not window or b <= window:
        return upto(b) - upto(a - 1)
    if a > window:
        return n * window
    return upto(window) - upto(a - 1) + (b - window) * window


def attention_call(lanes: Iterable[Lane], m: dict, window, page: int,
                   kv_bytes: int = F32) -> Tuple[float, float]:
    """(operations, bytes) of one layer's paged attention over ``lanes``:
    QK^T and PV over each query's live keys (causal, and inside the
    window where ``window`` is set); q read and the output written once,
    and each lane's K and V pages read once."""
    hd, nh, nkv = m["head_dim"], m["n_heads"], m["n_kv_heads"]
    keys = pages = rows = 0
    for ln in lanes:
        keys += _keys(ln.q0, ln.n, window)
        lo = max(0, ln.q0 - window + 1) if window else 0
        pages += _pages(lo, ln.q0 + ln.n, page)
        rows += ln.n
    flops = 4.0 * hd * nh * keys
    nbytes = (2.0 * rows * nh * hd * F32
              + 2.0 * pages * page * nkv * hd * kv_bytes)
    return flops, nbytes


def attention_windows(m: dict) -> Dict:
    """{window (None for global): attention layers with it}."""
    out: Dict = {}
    for layer in range(m["n_layers"]):
        kind = m["pattern"][layer % len(m["pattern"])]
        if kind.startswith(("attn", "hybrid")):
            w = m["window"] if kind.endswith("_local") else None
            out[w] = out.get(w, 0) + 1
    return out


def projections(m: dict, q: dict) -> List[Proj]:
    """Every matrix product of a step of ``m``, with the format's rule
    for which weights are quantized (``refquant.quantized_shape``)."""
    from qmcbench.refquant import quantized_shape
    from qmcbench.weights import leaf_shapes
    out = []
    for path, shape in leaf_shapes(m):
        name = path.split("/")[-1]
        if name not in PRODUCTS:
            continue
        calls = shape[0] if len(shape) == 3 else 1
        out.append(Proj(shape[-2], shape[-1], calls,
                        quantized_shape(path, shape, q),
                        head=name == "lm_head"))
    return out


PRODUCTS = ("wq", "wk", "wv", "wo", "in_proj", "out_proj", "w_up", "w_gate",
            "w_down", "lm_head")


def ssm_layers(m: dict) -> int:
    return sum(1 for layer in range(m["n_layers"])
               if m["pattern"][layer % len(m["pattern"])].startswith(
                   ("mamba", "hybrid")))


def step_need(m: dict, q: dict, projs: List[Proj], lanes: List[Lane],
              emitting: int, page: int,
              kv_bytes: int = F32) -> Tuple[float, float]:
    """(operations, bytes) a whole step needs for its live tokens: every
    weight read once (QMC leaves at the format's bits, dense ones at
    fp32), the products of the live tokens (the head only for the
    ``emitting`` rows that give a token), the embedding rows, each
    attention layer's work and its new K/V written, and each SSM layer's
    state and conv window read and written per live lane with its
    recurrence (6 P N operations per head and token)."""
    tokens = sum(ln.n for ln in lanes)
    d = m["d_model"]
    flops = nbytes = 0.0
    for p in projs:
        rows = emitting if p.head else tokens
        flops += 2.0 * rows * p.k * p.n * p.calls
        nbytes += (qmc_bytes(p.k, p.n, q) if p.quantized
                   else p.k * p.n * F32) * p.calls
    nbytes += tokens * d * F32
    for window, layers in attention_windows(m).items():
        f, b = attention_call(lanes, m, window, page, kv_bytes)
        flops += f * layers
        nbytes += (b + 2.0 * tokens * m["n_kv_heads"] * m["head_dim"]
                   * kv_bytes) * layers
    n_ssm = ssm_layers(m)
    if n_ssm:
        di = m["expand"] * d
        nh, hp, n = di // m["ssm_headdim"], m["ssm_headdim"], m["d_state"]
        conv = di + 2 * m["ssm_ngroups"] * n
        state = nh * hp * n * F32 + (m["d_conv"] - 1) * conv * F32
        flops += n_ssm * 6.0 * nh * hp * n * tokens
        nbytes += n_ssm * 2.0 * state * len(lanes)
    return flops, nbytes
