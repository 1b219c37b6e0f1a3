"""Per-step cost attribution: counted kernel work x engine counters x DSE
(a port of ``repro.obs.costs``).

The paper's headline numbers are deployment *costs* (external transfers,
energy, latency per token) but the serving stack only measures wall time.
This module closes that gap three ways, per engine run:

  1. **Count** — with :func:`enable_capture` on, the step set's ``step``
     and ``solo_step`` (``serve/steps.py``) record, once per (callable,
     width), the work of one call at that padded shape (:func:`step_work`:
     every projection, the attention over the full block table, the
     lm_head), counted from the step set's geometry and the parameters'
     leaf shapes with the same formulas as the kernels' bounds
     (``launch/roofline.py``). There is no XLA ``cost_analysis()`` to
     ask; the count is static, as XLA's is.
  2. **Attribute** — :func:`attribute` diffs the step set's per-width
     call/wall tables across a run and scores each (fn, width) against
     its roofline bound on the H100 (``launch/roofline.py``): measured
     wall seconds vs ``calls * max(flops x products / TF32 peak,
     bytes / HBM bandwidth)``, plus arithmetic intensity. The drift ratio
     (measured / roofline) is the model-vs-measured health signal.
  3. **Model** — the same run's ``EngineStats`` page/token counters feed
     the Eq. (3)/(4) DSE (``memsys/workload.py`` traffic +
     ``memsys/system.py`` evaluate_hetero / evaluate_conventional), so
     each run also reports *modeled* bytes / energy / latency per round
     and per token for the weight format it actually served.

Exports land on the obs surfaces via :func:`flush_metrics`
(``serve_cost_*`` instruments per the ``obs/metrics.py`` contract) and
the ``cost/<fn>`` counter tracks the step set emits per call. Wired end
to end by ``launch/serve.py --cost-report``.

Sampling and speculative verification need no rows of their own: token
selection runs inside the step, and a verify call is the step at a
``width_ladder`` rung, so it lands in that rung's ``C<width>`` row. The
invariant the tests pin: one engine round == exactly one attributed
``step``/``solo_step`` dispatch. The page ops (``apply_page_ops``) get
call/wall rows with no count, so their drift is suppressed.

Capture is OFF by default: the only cost any other path pays is one
module-bool branch per step-set call. Turning it on makes each call
synchronous (``torch.cuda.synchronize()`` inside the timed window) so
the per-width wall tables measure device time, not the enqueue — a
measurement mode, not a serving mode; on the card it runs outside every
graph capture.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch import tree as T
from repro_torch.core.qtensor import QTensor
from repro_torch.core.qtensor_sharded import ShardedQTensor
from repro_torch.kernels.ops import qmm_plan
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import roofline as rl
from repro_torch.launch import sharding as shd
from repro_torch.memsys.system import (MemSystemConfig, evaluate_conventional,
                                       evaluate_hetero)
from repro_torch.memsys.workload import (act_bits_per_step, kv_bits_per_step,
                                         make_traffic)
from repro_torch.models.model import init_params
from repro_torch.models.moe import capacity
from repro_torch.models.ssm import chunk_for

# ---------------------------------------------------------------------------
# capture switch
# ---------------------------------------------------------------------------
_CAPTURE = False


def enable_capture(on: bool = True) -> bool:
    """Turn per-call cost capture on/off; returns the previous state."""
    global _CAPTURE
    prev, _CAPTURE = _CAPTURE, bool(on)
    return prev


def capture_enabled() -> bool:
    return _CAPTURE


# ---------------------------------------------------------------------------
# the count: one step call's work at a padded shape
# ---------------------------------------------------------------------------
_PROJECTIONS = {"attn": ("wq", "wk", "wv", "wo"),
                "mamba": ("in_proj", "out_proj"),
                "ffn": ("w_up", "w_gate", "w_down")}


def step_work(cfg, params: dict, arena: dict, *, lanes: int, c: int
              ) -> Dict[str, object]:
    """``{"flops", "bytes", "dtype"}`` of one step call over ``lanes``
    lanes at token width ``c`` (``lanes = 1`` for ``solo_step``).

      * each projection at the rows its matmul runs: a QTensor leaf
        through ``kernels.ops.qmm`` at M padded to 8 (``qmm_plan``), with
        its int8 codes, subtile metadata and scales; a dense leaf at M;
      * each MoE FFN (``launch/roofline.py:moe_work``): the router at M,
        every expert's products at the call's capacity rows
        (``models/moe.py:capacity``, padded by ``qmm_plan`` on a
        QTensor), the dispatch and the combine;
      * each attention layer over the full ``[lanes, P]`` block table:
        q, every page of every lane's table row, the softmax over all
        ``P * page`` keys, o, m and l (a static count, as XLA's is);
      * each Mamba2 mixer's state and scan (``launch/roofline.py:
        ssd_work``): every lane's ``ssm`` and ``conv`` rows read and
        written, the recurrence at C = 1, the chunked scan at the
        width's chunk above it;
      * the lm_head (or the tied embedding) at M.

    On a mesh rank (its slice of the parameters and the arena) the count
    is the rank's own work: its shard of each ShardedQTensor, its slice of
    each cut leaf, only the experts it holds (an expert list's ``None``
    entries are another rank's), its KV heads (read off the arena: all of
    them, and every query head, where the attention block replicates)
    and the whole Mamba2 mixer, which every model rank runs.

    Norms, rotary, the K/V scatter, the conv taps, the residual adds,
    the softmax's exponentials and the sampling head are not counted: a
    few operations per element, against 2K per output element of a
    projection (at the 64-wide test model they are ~10% of XLA's
    count)."""
    act = params["embed"]["tok"].dtype
    xb = act.itemsize
    m = lanes * c
    flops = nbytes = 0.0

    def work(w, rows: int) -> Tuple[float, float]:
        if isinstance(w, ShardedQTensor):        # the shards it holds
            parts = [work(w.local(i), rows) for i in w.held]
            return (sum(b for b, _ in parts), sum(f for _, f in parts))
        if isinstance(w, QTensor):
            k, n = w.shape
            m_run = qmm_plan(rows, k, n, w.subtile)["pad_m"]
            return rl.qmm_work(m_run, k, n, xb, w.subtile)
        k, n = w.shape[-2:]
        return rl.matmul_work(rows, k, n, xb, w.element_size())

    def matmul(w) -> None:
        nonlocal flops, nbytes
        b, f = work(w, m)
        nbytes += b
        flops += f

    cap = capacity(m, cfg) if cfg.n_experts else 0
    for key, blk in params["blocks"].items():
        grp = arena[key]
        moe = cfg.moe_slots[int(key[1:])] and "ffn" in blk
        for g in range(cfg.n_groups):
            for part, names in _PROJECTIONS.items():
                if part == "ffn" and moe:
                    continue
                for name in names:
                    if name in blk.get(part, {}):
                        matmul(blk[part][name][g])
            works = []
            if moe:
                ffn = blk["ffn"]
                router = ffn["router"][g]
                held = [w_e for w_e in ffn["w_up"][g] if w_e is not None]
                works.append(rl.moe_work(
                    m=m, cap=cap, d=cfg.d_model, n_experts=len(held),
                    topk=cfg.topk, x_itemsize=xb,
                    router_itemsize=router.element_size(),
                    experts=[work(w_e, cap)
                             for name in _PROJECTIONS["ffn"] if name in ffn
                             for w_e in ffn[name][g] if w_e is not None]))
            if "attn" in grp:
                cache = grp["attn"]
                n_tbl = cache["block_tbl"].shape[-1]
                page = cache["k_pages"].shape[-2]
                n_kv = cache["k_pages"].shape[-1] // cfg.head_dim
                works.append(rl.attention_work(
                    lanes=lanes, s=c,
                    n_heads=cfg.n_heads * n_kv // cfg.n_kv_heads,
                    n_kv=n_kv, hd=cfg.head_dim, page=page,
                    pages=lanes * n_tbl, keys=lanes * c * n_tbl * page,
                    tbl_entries=lanes * n_tbl, q_itemsize=xb,
                    kv_itemsize=cache["k_pages"].element_size(),
                    kv_scaled="k_scale_pages" in cache))
            if "mamba" in grp:
                conv = grp["mamba"]["conv"]
                works.append(rl.ssd_work(
                    lanes=lanes, s=c, chunk=chunk_for(c),
                    heads=cfg.ssm_nheads,
                    headdim=cfg.ssm_headdim, d_state=cfg.d_state,
                    conv_rows=conv.shape[-2], conv_dim=conv.shape[-1],
                    conv_itemsize=conv.element_size()))
            for b, f in works:
                nbytes += b
                flops += f
    if cfg.tie_embeddings:
        matmul(params["embed"]["tok"].T)
    else:
        matmul(params["lm_head"])
    return {"flops": flops, "bytes": nbytes,
            "dtype": str(act).replace("torch.", "")}


def contiguous_work(cfg, params: dict, cache: dict, *, rows: int, s: int,
                    dp: int = 1) -> Dict[str, object]:
    """``{"flops", "matmul_flops", "bytes", "dtype"}`` of one contiguous
    call (``serve.steps.build_prefill`` at ``s`` tokens a row,
    ``build_decode`` at ``s = 1``) over ``rows`` rows, on one rank of a
    mesh (its parameter slices and its cache, ``launch.sharding.
    local_cache``) or one process, as ``step_work`` counts a paged call:

      * each projection at ``rows * s`` rows (a VLM's layers at ``rows *
        (s + n_vis)`` on a prefill, its visual prefix included), QTensor
        leaves at qmm's padded M (``qmm_plan``), the held shard of a
        ShardedQTensor, the held experts of a list;
      * each attention layer over the whole cache slab of ``T`` positions
        (``attend`` scores every key and masks: a static count, as XLA's
        is), q read, K/V of ``rows x T`` read, o written;
      * each MoE FFN at ``models.moe.capacity`` rows a held expert
        (``launch/roofline.py:moe_work``): the capacity of the call's
        rows, or with the rows split over ``dp`` ranks
        (``serve.steps.build_prefill`` / ``build_decode`` where the batch
        divides) of all ``dp`` ranks' rows, the most a rank runs (it
        runs its kept rows of its busiest expert, which the routing
        decides); each Mamba2 mixer's state and scan (``ssd_work``);
      * an encoder-decoder's encoder on a prefill (its layers at ``rows
        * enc_seq`` rows, their non-causal attention over ``enc_seq``
        keys) and the cross-attention: ``wq`` at the call's rows, ``wk`` /
        ``wv`` at the frames' rows on a prefill only (a decode reads the
        cached ``xk`` / ``xv``), the scores over ``enc_seq`` keys;
      * the head at every row of the call (``forward`` computes the
        logits of every position; ``prefill`` keeps the last).

    ``matmul_flops`` is the part of ``flops`` that ``torch.matmul``,
    ``torch.bmm`` and ``torch.einsum`` run on dense weights (every term
    above but the MoE combine and the one-token SSM recurrence), which
    ``torch.utils.flop_counter.FlopCounterMode`` counts too. Norms,
    rotary, the cache writes, the conv taps and the softmax are not
    counted."""
    act = params["embed"]["tok"].dtype
    xb = act.itemsize
    vis = cfg.n_vis_tokens if s > 1 else 0
    m = rows * (s + vis)
    enc_m = rows * cfg.enc_seq if (cfg.is_encdec and s > 1) else 0
    tot = {"flops": 0.0, "matmul": 0.0, "bytes": 0.0}

    def add(b: float, f: float, mm: bool = True) -> None:
        tot["bytes"] += b
        tot["flops"] += f
        if mm:
            tot["matmul"] += f

    def work(w, n_rows: int) -> Tuple[float, float]:
        if isinstance(w, ShardedQTensor):
            parts = [work(w.local(i), n_rows) for i in w.held]
            return (sum(b for b, _ in parts), sum(f for _, f in parts))
        if isinstance(w, QTensor):
            k, n = w.shape
            m_run = qmm_plan(n_rows, k, n, w.subtile)["pad_m"]
            return rl.qmm_work(m_run, k, n, xb, w.subtile)
        k, n = w.shape[-2:]
        return rl.matmul_work(n_rows, k, n, xb, w.element_size())

    def attention(n_heads: int, n_kv: int, q_rows: int, t: int,
                  kv_itemsize: int, scaled: bool = False) -> None:
        add(*rl.attention_work(
            lanes=rows, s=q_rows, n_heads=n_heads, n_kv=n_kv,
            hd=cfg.head_dim, page=t, pages=rows, keys=rows * q_rows * t,
            tbl_entries=0, q_itemsize=xb, kv_itemsize=kv_itemsize,
            kv_scaled=scaled))

    def heads(n_kv: int) -> Tuple[int, int]:
        """(query heads, KV heads) of a rank holding ``n_kv`` KV heads."""
        return cfg.n_heads * n_kv // cfg.n_kv_heads, n_kv

    enc = cfg.is_encdec
    dec_cache = cache["b0"]["self"] if enc else None
    for key, blk in params["blocks"].items():
        moe = cfg.moe_slots[int(key[1:])] and "ffn" in blk
        for g in range(cfg.n_groups):
            for part, names in _PROJECTIONS.items():
                if part == "ffn" and moe:
                    continue
                for name in names:
                    if name in blk.get(part, {}):
                        add(*work(blk[part][name][g], m))
            if moe:
                ffn = blk["ffn"]
                router = ffn["router"][g]
                held = [w_e for w_e in ffn["w_up"][g] if w_e is not None]
                cap = capacity(m * dp, cfg)
                experts = [work(w_e, cap)
                           for name in _PROJECTIONS["ffn"] if name in ffn
                           for w_e in ffn[name][g] if w_e is not None]
                b, f = rl.moe_work(
                    m=m, cap=cap, d=cfg.d_model, n_experts=len(held),
                    topk=cfg.topk, x_itemsize=xb,
                    router_itemsize=router.element_size(), experts=experts,
                    router_experts=cfg.n_experts)
                combine = 2.0 * m * cfg.topk * cfg.d_model
                add(b, f - combine)
                add(0.0, combine, mm=False)
            grp = dec_cache if enc else cache[key]
            if enc or "attn" in grp:
                kv = grp if enc else grp["attn"]
                t = kv["k"].shape[-2]
                nh, n_kv = heads(kv["k"].shape[-1] // cfg.head_dim)
                attention(nh, n_kv, s + vis, t, kv["k"].element_size(),
                          "k_scale" in kv)
            if not enc and "mamba" in grp:
                conv = grp["mamba"]["conv"]
                b, f = rl.ssd_work(
                    lanes=rows, s=s + vis, chunk=chunk_for(s + vis),
                    heads=cfg.ssm_nheads, headdim=cfg.ssm_headdim,
                    d_state=cfg.d_state, conv_rows=conv.shape[-2],
                    conv_dim=conv.shape[-1],
                    conv_itemsize=conv.element_size())
                add(b, f, mm=s + vis > 1)
    if enc:
        xa = params["xattn"]["xattn"]
        cross = cache["b0"]["cross"]
        nh, n_kv = heads(cross["xk"].shape[-2])
        for g in range(cfg.n_layers):
            add(*work(xa["wq"][g], m))
            add(*work(xa["wo"][g], m))
            if enc_m:
                add(*work(xa["wk"][g], enc_m))
                add(*work(xa["wv"][g], enc_m))
            attention(nh, n_kv, s, cfg.enc_seq, cross["xk"].element_size())
        if enc_m:
            eb = params["encoder"]["blocks"]
            for g in range(cfg.n_enc_layers):
                for part, names in _PROJECTIONS.items():
                    for name in names:
                        if name in eb.get(part, {}):
                            add(*work(eb[part][name][g], enc_m))
                attention(nh, n_kv, cfg.enc_seq, cfg.enc_seq, xb)
    head = (params["embed"]["tok"].T if cfg.tie_embeddings
            else params["lm_head"])
    add(*work(head, rows * s))
    return {"flops": tot["flops"], "matmul_flops": tot["matmul"],
            "bytes": tot["bytes"], "dtype": str(act).replace("torch.", "")}


# the leaves a training step multiplies by (the head: lm_head, or the tied
# embedding table)
_TRAIN_MATMULS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                  "router", "in_proj", "out_proj", "lm_head")


def train_step_work(cfg, mesh=None, *, tokens: int, remat: bool = True,
                    enc_tokens: int = 0, vis_tokens: int = 0,
                    itemsize: Optional[int] = None,
                    moment_itemsize: int = 4) -> Dict[str, float]:
    """``{"flops", "forward_flops"}``: the matmul FLOPs of one
    training step (``train.step``) on a rank of ``mesh`` (one process
    without) over its ``tokens`` rows, counted from the model's shapes
    and the training rules (``launch.sharding.param_spec`` with ``cfg``),
    as ``step_work`` counts a serving call:

      * every projection at ``tokens`` rows with the rank's part of its
        weight: cut over ``model`` where the rules cut it (column- or
        row-parallel, a vocab slice of the head), whole along ``data``
        (FSDP gathers it before use), and whole on every model rank where
        the rules replicate it (an attention block whose heads do not
        divide ``model``, a head whose vocab does not);
      * a VLM's layers at ``tokens + vis_tokens`` rows (the visual prefix
        runs through them; the head does not);
      * an encoder-decoder's encoder layers, and its cross-attention's
        ``wk`` / ``wv``, at the frames' ``enc_tokens`` rows;
      * each MoE FFN: the router at ``tokens`` rows, and each expert the
        rank holds (its ``E / M`` under expert parallelism; all ``E``,
        each cut to its ``d_ff / M`` hidden units, under the Megatron
        fallback) at ``models.moe.capacity(tokens)`` rows (a call's
        capacity over the rank's rows; with rows split over dp the block
        runs at most the rank's kept rows of the global capacity, which
        depend on the routing and are not counted here).

    The forward counts once, the backward twice (the input's and the
    weight's gradients) and, with ``remat``, the layers' recompute once
    more; the head is not recomputed. Attention scores, the SSD scan,
    the norms and the optimizer's arithmetic are not counted. Given the
    parameters' ``itemsize`` the dict also holds ``bytes``: each of those
    products' operands read and result written once
    (``launch/roofline.py:matmul_work``), and the
    AdamW update over the rank's slice of every leaf (the parameter and
    its gradient read, the parameter written; both moments read and
    written at ``moment_itemsize``)."""
    layers = head = 0.0
    layer_bytes = head_bytes = opt_bytes = 0.0
    block_rows = tokens + vis_tokens
    size = itemsize or 4
    for path, leaf in T.items(init_params(cfg, device="meta")):
        name = path.split("/")[-1]
        shape = list(leaf.shape)
        part = list(leaf.shape)
        if mesh is not None:
            for i, ax in enumerate(shd.param_spec(path, leaf, mesh, cfg)):
                if ax == "model":
                    shape[i] //= meshlib.axis_size(mesh, "model")
                if ax is not None:
                    part[i] //= meshlib.axis_size(mesh, ax)
        n_part = 1
        for d in part:
            n_part *= d
        opt_bytes += n_part * (3 * size + 4 * moment_itemsize)
        if name not in _TRAIN_MATMULS and not (
                path == "embed/tok" and cfg.tie_embeddings):
            continue
        if path.startswith(("blocks/", "encoder/", "xattn/")):
            g, shape = shape[0], shape[1:]
            rows = (enc_tokens if path.startswith("encoder/") or (
                path.startswith("xattn/") and name in ("wk", "wv"))
                else block_rows)
            if len(shape) == 3:                       # [E, k, n] experts
                rows = capacity(rows, cfg)
                b, f = rl.matmul_work(rows, shape[1], shape[2], size,
                                      size)
                layers += g * shape[0] * f
                layer_bytes += g * shape[0] * b
            else:
                b, f = rl.matmul_work(rows, shape[0], shape[1], size,
                                      size)
                layers += g * f
                layer_bytes += g * b
        else:                                         # the head [d, V]
            if path == "embed/tok":                   # tied: [V, d]
                shape = shape[::-1]
            b, f = rl.matmul_work(tokens, shape[0], shape[1], size, size)
            head += f
            head_bytes += b
    passes = 4 if remat else 3
    out = {"flops": layers * passes + head * 3,
           "forward_flops": layers + head}
    if itemsize is not None:
        out["bytes"] = layer_bytes * passes + head_bytes * 3 + opt_bytes
    return out


# ---------------------------------------------------------------------------
# per-(fn, shape) attribution rows
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class FnCost:
    """One (step function, call shape) row of the attribution table."""
    fn: str                          # step / solo_step / apply_page_ops
    key: str                         # call-shape key, e.g. "C1" / "C16"
    calls: int
    wall_s: float                    # measured (synchronous) wall seconds
    flops_per_call: float
    bytes_per_call: float
    act_dtype: str = "float32"       # picks the compute peak

    @property
    def label(self) -> str:
        return f"{self.fn}/{self.key}"

    @property
    def captured(self) -> bool:
        return self.flops_per_call > 0 or self.bytes_per_call > 0

    def roofline(self) -> rl.Roofline:
        return rl.from_artifacts(
            self.fn, self.key, "-", 1,
            {"flops": self.flops_per_call,
             "bytes accessed": self.bytes_per_call},
            act_dtype=self.act_dtype)

    @property
    def roofline_s(self) -> float:
        """Bound time for all calls: max(compute, memory) per call."""
        return self.calls * self.roofline().roofline_time

    @property
    def drift(self) -> float:
        """Measured / roofline-bound wall time (>= 1 in practice; 0 for a
        row with no count)."""
        r = self.roofline_s
        return self.wall_s / r if r > 0 else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the roofline bound achieved (roofline / measured)."""
        return self.roofline_s / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def arithmetic_intensity(self) -> float:
        """FLOPs per byte moved — where on the roofline this shape sits."""
        return (self.flops_per_call / self.bytes_per_call
                if self.bytes_per_call > 0 else 0.0)

    def to_dict(self) -> dict:
        return {"fn": self.fn, "key": self.key, "calls": self.calls,
                "wall_s": self.wall_s,
                "flops_per_call": self.flops_per_call,
                "bytes_per_call": self.bytes_per_call,
                "act_dtype": self.act_dtype,
                "roofline_s": self.roofline_s, "drift": self.drift,
                "roofline_fraction": self.roofline_fraction,
                "arithmetic_intensity": self.arithmetic_intensity}


def _traced_members(step_set):
    """The step set's members with cost tables, duck-typed (no import of
    ``serve.steps`` — it imports this module)."""
    for name in ("step", "solo_step", "apply_page_ops"):
        fn = getattr(step_set, name, None)
        if fn is not None and hasattr(fn, "cost_by_key"):
            yield fn


def snapshot(step_set) -> Dict[Tuple[str, str], Tuple[int, float]]:
    """Per-(fn, shape) (calls, wall seconds) tables right now — diff two
    of these around a run to attribute that run only."""
    out = {}
    for fn in _traced_members(step_set):
        for key, n in fn.calls_by_key.items():
            out[(fn.name, key)] = (n, fn.seconds_by_key.get(key, 0.0))
    return out


def collect(step_set, baseline=None) -> List[FnCost]:
    """Attribution rows for a step set, minus an optional prior
    :func:`snapshot` (so warm engines report only their own run)."""
    baseline = baseline or {}
    rows = []
    for fn in _traced_members(step_set):
        for key, n in fn.calls_by_key.items():
            n0, s0 = baseline.get((fn.name, key), (0, 0.0))
            calls = n - n0
            if calls <= 0:
                continue
            cost = fn.cost_by_key.get(key, {})
            rows.append(FnCost(
                fn=fn.name, key=key, calls=calls,
                wall_s=fn.seconds_by_key.get(key, 0.0) - s0,
                flops_per_call=float(cost.get("flops", 0.0)),
                bytes_per_call=float(cost.get("bytes", 0.0)),
                act_dtype=str(cost.get("dtype", "float32"))))
    rows.sort(key=lambda r: -r.wall_s)
    return rows


# ---------------------------------------------------------------------------
# modeled memory-system cost from EngineStats counters
# ---------------------------------------------------------------------------
def detect_weights_method(params) -> str:
    """Map a serving params tree to a ``make_traffic`` method name.

    QTensor leaves anywhere (alone or in per-group lists) -> ``qmc``; else
    an fp32 tensor decides ``fp32``, and ``fp16`` otherwise (bf16 streams
    16 bits too)."""
    import torch

    def leaves(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                yield from leaves(v)
        elif isinstance(tree, list):
            for v in tree:
                yield from leaves(v)
        else:
            yield tree

    found = list(leaves(params))
    if any(isinstance(x, QTensor) for x in found):
        return "qmc"
    if any(getattr(x, "dtype", None) == torch.float32 for x in found):
        return "fp32"
    return "fp16"


def modeled_memsys(cfg, stats, *, method: str, page: int,
                   kv_dtype_bits: int = 16, qmc=None,
                   sys_cfg: Optional[MemSystemConfig] = None) -> dict:
    """Eq. (3)/(4) cost of the run the engine just measured.

    Rebinds a :func:`make_traffic` stream to THIS run's averages: per
    round (one step), weights stream once, the KV stream is the page
    count the engine actually gathered/wrote (``kv_pages_live`` decode
    reads + ``prefill_kv_pages_live`` chunk reads + page-rounded writes,
    the same accounts ``kv_traffic_paged/chunked`` charge), and
    activations scale with the lane-steps the round carried. Returns a
    JSON-able dict with per-round bits, bytes/token and the
    ``evaluate_hetero`` / ``evaluate_conventional`` results; degenerate
    runs (no rounds or no tokens) report zeros with ``degenerate=True``.
    """
    from repro_torch.core.qconfig import QMCConfig
    sys_cfg = sys_cfg or MemSystemConfig()
    rounds = int(getattr(stats, "rounds", 0))
    tokens = int(getattr(stats, "tokens_out", 0))
    if rounds <= 0 or tokens <= 0:
        return {"method": method, "degenerate": True,
                "rounds": rounds, "tokens_out": tokens,
                "bytes_per_round": 0.0, "bytes_per_token": 0.0,
                "weight_bits_per_round": 0.0, "kv_bits_per_round": 0.0,
                "act_bits_per_round": 0.0}

    per_page_bits = (kv_bits_per_step(cfg, page, kv_dtype_bits)
                     - kv_bits_per_step(cfg, 0, kv_dtype_bits))
    ssm_bits = kv_bits_per_step(cfg, 0, kv_dtype_bits)
    lane_steps = tokens + int(getattr(stats, "prefill_chunks", 0))
    pages_read = (int(getattr(stats, "kv_pages_live", 0))
                  + int(getattr(stats, "prefill_kv_pages_live", 0)))
    kv_read = pages_read * per_page_bits + lane_steps * ssm_bits
    kv_write = (int(getattr(stats, "prefill_kv_pages_written", 0))
                * per_page_bits + tokens * per_page_bits / page)

    base = make_traffic(cfg, method, qmc=qmc or QMCConfig())
    traffic = dataclasses.replace(
        base, name=f"{base.name}+run",
        kv_bits=(kv_read + kv_write) / rounds,
        act_bits=act_bits_per_step(cfg) * lane_steps / rounds)
    het = evaluate_hetero(traffic, sys_cfg)
    conv = evaluate_conventional(traffic, sys_cfg, legacy_flash=False)

    bits_per_round = traffic.weight_bits + traffic.kv_bits \
        + traffic.act_bits

    def _res(r) -> dict:
        return {"latency_s": r.latency_s, "energy_j": r.energy_j,
                "external_bits": r.external_bits, "power_w": r.power_w,
                "feasible": r.feasible}

    return {
        "method": method, "degenerate": False,
        "rounds": rounds, "tokens_out": tokens,
        "weight_bits_per_round": traffic.weight_bits,
        "kv_bits_per_round": traffic.kv_bits,
        "act_bits_per_round": traffic.act_bits,
        "bytes_per_round": bits_per_round / 8.0,
        "bytes_per_token": bits_per_round * rounds / 8.0 / tokens,
        "hetero": _res(het),
        "conventional": _res(conv),
        "energy_j_per_token": het.energy_j * rounds / tokens,
        "latency_s_per_token": het.latency_s * rounds / tokens,
    }


# ---------------------------------------------------------------------------
# the full report
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CostReport:
    """One run's cost attribution: per-(fn, shape) roofline rows + the
    modeled memory-system cost of the same run."""
    fns: List[FnCost]
    modeled: dict
    measured_wall_s: float
    measured_device_s: float
    tokens_out: int

    def to_dict(self) -> dict:
        return {"fns": [r.to_dict() for r in self.fns],
                "modeled": self.modeled,
                "measured_wall_s": self.measured_wall_s,
                "measured_device_s": self.measured_device_s,
                "tokens_out": self.tokens_out}

    def table(self) -> str:
        lines = [f"{'fn/shape':20s} {'calls':>6s} {'wall_s':>9s} "
                 f"{'roofline_s':>10s} {'drift':>7s} {'ai':>7s}"]
        for r in self.fns:
            lines.append(
                f"{r.label:20s} {r.calls:6d} {r.wall_s:9.4f} "
                f"{r.roofline_s:10.6f} "
                f"{(f'{r.drift:7.1f}' if r.captured else '      -')} "
                f"{(f'{r.arithmetic_intensity:7.2f}' if r.captured else '      -')}")
        m = self.modeled
        if m and not m.get("degenerate"):
            lines.append(
                f"modeled[{m['method']}]: "
                f"{m['bytes_per_token'] / 1e6:.2f} MB/token, "
                f"hetero {m['energy_j_per_token'] * 1e3:.3f} mJ/token "
                f"{m['latency_s_per_token'] * 1e3:.3f} ms/token "
                f"(feasible={m['hetero']['feasible']})")
        return "\n".join(lines)


def attribute(step_set, stats, *, cfg, params=None,
              method: Optional[str] = None, page: int,
              kv_dtype_bits: int = 16, baseline=None, qmc=None,
              sys_cfg: Optional[MemSystemConfig] = None) -> CostReport:
    """Assemble a run's :class:`CostReport` from its step set + stats."""
    if method is None:
        method = detect_weights_method(params) if params is not None \
            else "fp16"
    return CostReport(
        fns=collect(step_set, baseline),
        modeled=modeled_memsys(cfg, stats, method=method, page=page,
                               kv_dtype_bits=kv_dtype_bits, qmc=qmc,
                               sys_cfg=sys_cfg),
        measured_wall_s=float(getattr(stats, "wall_s", 0.0)),
        measured_device_s=float(stats.device_seconds()
                                if hasattr(stats, "device_seconds")
                                else 0.0),
        tokens_out=int(getattr(stats, "tokens_out", 0)))


def flush_metrics(reg, report: CostReport) -> None:
    """Fold a report into a metrics registry per the ``serve_cost_*``
    contract (``obs/metrics.py``). The drift gauge is only set for rows
    with a count — a row with none suppresses it rather than reporting
    drift=0 as if the step hit its roofline."""
    flops = reg.counter("serve_cost_flops_total",
                        "counted FLOPs executed, per fn/shape",
                        labels=("fn",))
    nbytes = reg.counter("serve_cost_bytes_total",
                         "counted bytes moved, per fn/shape",
                         labels=("fn",))
    drift = reg.gauge("serve_cost_drift_ratio",
                      "measured wall / roofline bound, per fn/shape",
                      labels=("fn",))
    for r in report.fns:
        flops.inc(r.flops_per_call * r.calls, fn=r.label)
        nbytes.inc(r.bytes_per_call * r.calls, fn=r.label)
        if r.captured:
            drift.set(r.drift, fn=r.label)
    m = report.modeled
    if m and not m.get("degenerate"):
        reg.gauge("serve_cost_modeled_bytes_per_token",
                  "Eq.(3)/(4) modeled memory traffic per emitted token"
                  ).set(m["bytes_per_token"])
        e = reg.gauge("serve_cost_modeled_energy_j",
                      "modeled per-round memory energy", labels=("system",))
        lat = reg.gauge("serve_cost_modeled_latency_s",
                        "modeled per-round memory latency",
                        labels=("system",))
        for system in ("hetero", "conventional"):
            e.set(m[system]["energy_j"], system=system)
            lat.set(m[system]["latency_s"], system=system)
