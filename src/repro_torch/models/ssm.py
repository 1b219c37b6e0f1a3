"""Mamba2: the state-space duality (SSD) mixer, a chunked scan for prefill
and the O(1) recurrence for decode (counterpart of ``repro.models.ssm``).

Prefill runs the chunked SSD algorithm (arXiv:2405.21060 §6): quadratic,
attention-like work inside fixed-size chunks and linear state passing
across them. A Python loop over chunks takes the place of the reference's
``lax.scan``; a step width's chunk count is static, so a CUDA graph of the
step captures the loop unrolled. Decode is the recurrence on the
``[B, H, P, N]`` state. The formulas are the reference's: ``_segsum`` as
a difference of cumulative sums masked to ``-inf`` (``exp(-inf) = 0``
exactly), ``dt`` in fp32 before the softplus, padded positions at ``dt =
0`` and ``x = 0``.

On a serving mesh (``runtime_context.use_mesh``) ``in_proj`` is
column-parallel, as JAX's rule has it, but its cut does not fall on the
``z | xBC | dt`` boundaries, so the rank's columns are made whole right
after the product (``layers.gathered_linear``: one all_reduce over
``model``); the mixer (the conv, the scan or recurrence, the gated norm
over the whole ``d_inner``) then runs replicated on every model rank,
over the whole state of the rows it runs (a data rank's lanes where the
serving step splits them), and ``out_proj`` is row-parallel: the rank
multiplies its rows of ``y``, summed over ``model``
(``layers.row_linear``). A weight the mesh leaves whole (a dim that does
not divide, a stream whose cut would split a subtile) takes the plain
product. Splitting the heads, conv channels and state over ``model`` is
a later speed step (ROADMAP B).

On a training mesh the same layout carries gradients, and the replicated
mixer's are whole on every model rank (the one consistent design of two:
the other slices ``y`` plainly and sums partial mixer gradients over
``model``). ``x`` enters ``in_proj`` through ``layers.tp_input`` (its
gradient, partial over the rank's columns, summed over ``model``); the
gather after ``in_proj`` keeps the rank's slice of the whole gradient in
the backward; ``y`` reaches ``out_proj`` through
``collectives.split_model``, whose backward gathers the slices' gradients
into the whole ``dy``. So the mixer's replicated leaves (``a_log``,
``dt_bias``, ``d_skip``, ``norm_scale``) get the same whole gradient on
every model rank and are counted once, with no sum over ``model``. JAX's
rule cuts ``conv_w``'s channels over ``model``; training keeps that cut
and gathers the whole conv before the taps (``layers.tp_gather`` on dim
0, kind ``gather``), whose backward keeps the rank's channels of the
whole gradient. Serving holds ``conv_w`` whole and gathers nothing.

With a cache, ``mamba_block`` writes the new ``ssm`` and ``conv`` rows
into the cache tensors it was given, in place (``copy_``): the serving
step's graphs read the arena by address, so a rebinding would freeze
under replay.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (gathered_linear, rms_norm,
                                       row_linear, tp_gather)

CHUNK = 256


def chunk_for(s: int) -> int:
    """The scan's chunk at a window of ``s`` tokens: ``CHUNK`` from
    ``CHUNK`` tokens on, else the pow2 that covers ``s``, at least 8."""
    return CHUNK if s >= CHUNK else max(8, 1 << (s - 1).bit_length())


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a [..., L] -> M[..., i, j] = sum_{j < k <= i} a_k (lower-tri),
    ``-inf`` above the diagonal."""
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    n = a.shape[-1]
    ltri = torch.ones((n, n), dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~ltri, float("-inf"))


def ssd_chunked(x: torch.Tensor, a_dt: torch.Tensor, b_mat: torch.Tensor,
                c_mat: torch.Tensor, h0: Optional[torch.Tensor],
                chunk: int = CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan.

    x     [B,L,H,P]  (inputs already scaled by dt)
    a_dt  [B,L,H]    (dt * A, negative)
    b/c   [B,L,G,N]  (G groups broadcast over heads)
    h0    [B,H,P,N]  initial state or None
    Returns (y [B,L,H,P] in x's dtype, h_final [B,H,P,N] fp32)."""
    bsz, l, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    assert l % chunk == 0, (l, chunk)
    hg = h // g
    h_prev = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                          device=x.device) if h0 is None
              else h0.to(torch.float32))
    ys = []
    for c0 in range(0, l, chunk):
        xk = x[:, c0:c0 + chunk].to(torch.float32)
        ak = a_dt[:, c0:c0 + chunk]
        bk = b_mat[:, c0:c0 + chunk].to(torch.float32)
        ck = c_mat[:, c0:c0 + chunk].to(torch.float32)
        acs = torch.cumsum(ak, dim=1)                        # [B,chunk,H]
        # intra-chunk (diagonal block): attention-like
        lmat = torch.exp(_segsum(ak.transpose(1, 2)))        # [B,H,l,s]
        ckh = ck.repeat_interleave(hg, dim=2)                # [B,chunk,H,N]
        bkh = bk.repeat_interleave(hg, dim=2)
        scores = torch.einsum("blhn,bshn->bhls", ckh, bkh)
        y_diag = torch.einsum("bhls,bshp->blhp", scores * lmat, xk)
        # contribution of the incoming state
        y_off = torch.einsum("blhn,bhpn->blhp", ckh, h_prev) \
            * torch.exp(acs)[..., None]
        # chunk state update
        a_tot = acs[:, -1]                                   # [B,H]
        decay = torch.exp(a_tot[:, None] - acs)              # [B,chunk,H]
        h_new = torch.einsum("blhn,blhp->bhpn", bkh, decay[..., None] * xk)
        h_prev = h_prev * torch.exp(a_tot)[:, :, None, None] + h_new
        ys.append((y_diag + y_off).to(x.dtype))
    return torch.cat(ys, dim=1), h_prev


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 cache: Optional[torch.Tensor],
                 valid_len: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Depthwise causal conv1d. x [B,L,C]; w [C,K]; cache [B,K-1,C]. An
    explicit K-tap sum, the same products as the reference's grouped
    ``conv_general_dilated``.

    ``valid_len [B]`` marks the true sequence end inside a right-padded
    window: the returned cache then holds the K-1 inputs ending at the
    last valid token (input index t sits at row t + K-1 of the padded
    input, so rows valid_len..valid_len+K-2 are x[valid_len-K+1 :
    valid_len], with the pre-sequence zeros where valid_len < K-1). A
    lane with ``valid_len == 0`` gets its cache back unchanged."""
    bsz, l, ch = x.shape
    k = w.shape[1]
    if cache is None:
        xin = F.pad(x, (0, 0, k - 1, 0))
        new_cache = None
    else:
        xin = torch.cat([cache.to(x.dtype), x], dim=1)
        if valid_len is None:
            new_cache = xin[:, -(k - 1):, :]
        else:
            idx = valid_len.to(torch.int64)[:, None] + torch.arange(
                k - 1, device=x.device)[None, :]
            new_cache = torch.gather(xin, 1,
                                     idx[..., None].expand(bsz, k - 1, ch))
    w = w.to(x.dtype)
    out = xin[:, :l] * w[:, 0]
    for j in range(1, k):                    # the K taps, one product each
        out = out + xin[:, j:j + l] * w[:, j]
    return out, new_cache


def mamba_block(p: dict, x: torch.Tensor, cfg, *,
                cache: Optional[dict] = None,
                valid_len: Optional[torch.Tensor] = None,
                use_kernels: bool = True, tap=None) -> torch.Tensor:
    """Mamba2 mixer. ``cache = {"ssm": [B,H,P,N] fp32, "conv": [B,K-1,
    conv_dim]}`` is updated in place.

    ``valid_len [B]``: the count of valid columns in THIS input window
    (``blocks.apply_block`` converts the step's absolute bound). The
    recurrence is not immune to right padding, so padded positions get
    ``dt = 0`` and ``x = 0`` (state-neutral, as the chunk padding), the
    conv cache is gathered at the true window end, and a lane with
    ``valid_len == 0`` (idling in a mixed round) leaves both states
    bit for bit as they were, through the s == 1 recurrence too.
    ``tap(name, value)`` records the inputs of ``in_proj`` and
    ``out_proj`` for calibration."""
    bsz, s, _ = x.shape
    di, hd = cfg.d_inner, cfg.ssm_headdim
    nh, g, n = cfg.ssm_nheads, cfg.ssm_ngroups, cfg.d_state

    if tap:
        tap("in_proj", x)
    zxbcdt = gathered_linear(x, p["in_proj"], use_kernels,
                             2 * di + 2 * g * n + nh)
    z, xbc, dt = torch.split(zxbcdt, [di, cfg.conv_dim, nh], dim=-1)

    conv_w = p["conv_w"]
    if conv_w.shape[0] != cfg.conv_dim:     # channels cut over model
        conv_w = tp_gather(conv_w, cfg.conv_dim, dim=0)
    conv_cache = cache["conv"] if cache is not None else None
    xbc, new_conv = _causal_conv(xbc, conv_w, conv_cache,
                                 valid_len=valid_len)
    xbc = F.silu(xbc)
    xs, b_mat, c_mat = torch.split(xbc, [di, g * n, g * n], dim=-1)

    xh = xs.reshape(bsz, s, nh, hd)
    b_mat = b_mat.reshape(bsz, s, g, n)
    c_mat = c_mat.reshape(bsz, s, g, n)
    dt = F.softplus(dt.to(torch.float32)
                    + p["dt_bias"].to(torch.float32))        # [B,S,H]
    a = -torch.exp(p["a_log"].to(torch.float32))             # [H]

    h0 = cache["ssm"] if cache is not None else None
    if s == 1 and cache is not None:
        # O(1) decode recurrence
        da = torch.exp(dt[:, 0] * a[None, :])                # [B,H]
        bh = b_mat[:, 0].repeat_interleave(nh // g, dim=1)   # [B,H,N]
        bx = torch.einsum(
            "bhp,bhn->bhpn",
            (xh[:, 0] * dt[:, 0, :, None]).to(torch.float32),
            bh.to(torch.float32))
        h_new = h0 * da[:, :, None, None] + bx
        ch = c_mat[:, 0].repeat_interleave(nh // g, dim=1)   # [B,H,N]
        y = torch.einsum("bhpn,bhn->bhp", h_new, ch.to(torch.float32))
        y = y[:, None].to(x.dtype)                           # [B,1,H,P]
        h_final = h_new
        if valid_len is not None:
            # a lane idling in a mixed round (0 valid tokens) must not
            # advance its state on the padding token
            vm = (valid_len > 0)[:, None, None, None]
            h_final = torch.where(vm, h_new, h0)
    else:
        if valid_len is not None:
            vm = (torch.arange(s, device=x.device)[None, :]
                  < valid_len[:, None])                      # [B,S]
            dt = dt * vm[..., None]
            xh = xh * vm[:, :, None, None].to(xh.dtype)
        chunk = chunk_for(s)
        pad = (-s) % chunk
        if pad:
            xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
            dt = F.pad(dt, (0, 0, 0, pad))
            b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
            c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
        y, h_final = ssd_chunked(xh * dt[..., None].to(xh.dtype),
                                 dt * a[None, None, :], b_mat, c_mat,
                                 h0, chunk=chunk)
        y = y[:, :s].to(x.dtype)

    y = y + xh[:, :s] * p["d_skip"].to(x.dtype)[None, None, :, None]
    y = y.reshape(bsz, s, di)
    y = rms_norm(y * F.silu(z), p["norm_scale"], cfg.norm_eps)
    if tap:
        tap("out_proj", y)
    out = row_linear(y, p["out_proj"], None, use_kernels, di)

    if cache is not None:
        cache["ssm"].copy_(h_final)
        cache["conv"].copy_(new_conv)
    return out
