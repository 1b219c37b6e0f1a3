"""Wrapper of the ragged paged-attention kernel
(``csrc/paged_attention.cu``), the counterpart of
``repro.kernels.paged_attention.ragged_paged_attention``.

ONE kernel serves every attention read of the serving step: decode lanes
(one query token), prefill chunks (a block of query tokens scattered into
the arena just before) and idle lanes (``n_new = 0``, all rows dead), in
the same call. Lane ``b``'s queries sit at ``q_start[b] + t`` and attend
the pages of ``block_tbl[b]`` causally, bounded by ``kv_len[b]``; query
rows at or past ``kv_len`` emit exactly 0.

The kernel walks each (lane, KV head, q block of ``Q_BLOCK`` tokens)'s
causally live pages only. ``Q_BLOCK`` is mirrored by the host-side stream
account (``memsys.workload.chunk_pages_streamed`` and the engine's
``prefill_kv_pages_live`` counter), which must stay page-for-page with
the kernel's loop bound.

On a CPU tensor the wrapper runs the plain version
(``kernels.ref.ragged_paged_attention_ref``); on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.ref import ragged_paged_attention_ref

Q_BLOCK = 16
_ACC_LIMIT = 32 * 128     # R * hd the kernel's register accumulator holds
_SMEM_LIMIT = 48 * 1024   # shared memory a block may use without opt-in


def _check(q, cache, n_kv, head_dim):
    if q.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got {q.device}")
    if q.dtype != torch.float32 or q.ndim != 4:
        raise TypeError("q must be a float32 [B, S, H, hd] tensor")
    b, _, h, hd = q.shape
    if hd != head_dim or h % n_kv:
        raise ValueError((tuple(q.shape), n_kv, head_dim))
    kp, vp = cache["k_pages"], cache["v_pages"]
    if kp.ndim != 3 or kp.shape[-1] != n_kv * hd or kp.shape != vp.shape:
        raise ValueError("k/v pages must be [n_pages, page, KV*hd]")
    quantized = "k_scale_pages" in cache
    want = torch.int8 if quantized else torch.float32
    tensors = [kp, vp, cache["block_tbl"]]
    if kp.dtype != want or vp.dtype != want:
        raise TypeError(f"k/v pages must be {want}")
    if quantized:
        ks, vs = cache["k_scale_pages"], cache["v_scale_pages"]
        if ks.dtype != torch.bfloat16 or vs.dtype != torch.bfloat16 \
                or tuple(ks.shape) != (kp.shape[0], kp.shape[1], n_kv) \
                or ks.shape != vs.shape:
            raise TypeError("int8 pages need bf16 scales [n_pages, page, KV]")
        tensors += [ks, vs]
    tbl = cache["block_tbl"]
    if tbl.dtype != torch.int32 or tbl.ndim != 2 or tbl.shape[0] != b:
        raise TypeError("block_tbl must be int32 [B, P]")
    for t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"arena leaves must be contiguous on {q.device}")


def ragged_paged_attention_call(
        q: torch.Tensor, cache: dict, q_start: torch.Tensor,
        kv_len: torch.Tensor, *, n_kv: int, head_dim: int,
        window: Optional[int] = None, attn_softcap: Optional[float] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns ``(o [B, S, H, hd], m, l [B, S, H])`` in fp32: the output
    plus every row's softmax max and sum (what a cross-device merge of
    partial results needs)."""
    if q.device.type == "cpu":
        return ragged_paged_attention_ref(
            q, cache, q_start, kv_len, n_kv=n_kv, head_dim=head_dim,
            window=window, attn_softcap=attn_softcap)
    _check(q, cache, n_kv, head_dim)
    b, s, h, hd = q.shape
    g = h // n_kv
    q_blk = min(Q_BLOCK, s)
    qb_n = -(-s // q_blk)
    s_pad = qb_n * q_blk
    if q_blk * g * hd > _ACC_LIMIT:
        raise ValueError(f"q block of {q_blk * g} rows x hd {hd} exceeds "
                         f"the kernel's {_ACC_LIMIT}-value accumulator")
    lib = build.library()
    page = cache["k_pages"].shape[1]
    smem = lib.qmc_ragged_paged_attention_smem(q_blk * g, hd, page)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"kernel needs {smem} B of shared memory "
                         f"(> {_SMEM_LIMIT})")
    qp = q if s_pad == s else F.pad(q, (0, 0, 0, 0, 0, s_pad - s))
    qp = qp.contiguous()
    qs = q_start.to(device=q.device, dtype=torch.int32).contiguous()
    kl = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    if qs.shape != (b,) or kl.shape != (b,):
        raise ValueError("q_start and kv_len must be [B]")
    o = torch.empty((b, s_pad, h, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((b, s_pad, h), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    quantized = "k_scale_pages" in cache
    ks = cache["k_scale_pages"].data_ptr() if quantized else None
    vs = cache["v_scale_pages"].data_ptr() if quantized else None
    tbl = cache["block_tbl"]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.qmc_ragged_paged_attention(
            qp.data_ptr(), cache["k_pages"].data_ptr(),
            cache["v_pages"].data_ptr(), ks, vs, tbl.data_ptr(),
            qs.data_ptr(), kl.data_ptr(), o.data_ptr(), m.data_ptr(),
            l.data_ptr(), b, s_pad, h, n_kv, hd, page, tbl.shape[1], q_blk,
            int(window) if window is not None else 0,
            float(attn_softcap) if attn_softcap else 0.0,
            float(hd) ** -0.5, int(quantized), stream)
    build.check(rc, "ragged_paged_attention")
    build.count_launch("ragged_paged_attention")
    return o[:, :s], m[:, :s], l[:, :s]


def ragged_paged_attention(
        q: torch.Tensor, cache: dict, q_start: torch.Tensor,
        kv_len: torch.Tensor, *, n_kv: int, head_dim: int,
        window: Optional[int] = None, attn_softcap: Optional[float] = None
        ) -> torch.Tensor:
    """Ragged multi-query attention straight off the paged arena.

    q ``[B, S, H, hd]``; ``cache`` holds ``k_pages/v_pages [n_pages, page,
    KV*hd]`` (int8 layouts add ``{k,v}_scale_pages [n_pages, page, KV]``)
    and ``block_tbl [B, P]``; ``kv_len [B]`` is each lane's valid KV bound
    (``q_start + n_new`` for a chunk just scattered). Returns ``[B, S, H,
    hd]`` in q's dtype."""
    o, _, _ = ragged_paged_attention_call(
        q, cache, q_start, kv_len, n_kv=n_kv, head_dim=head_dim,
        window=window, attn_softcap=attn_softcap)
    return o.to(q.dtype)
