"""The plain reference: a whole sequence through the model in one pass,
with no cache, no paging, no batching and no kernel, in plain torch.

Its definition is the port's block, written out again: pre-norm RMSNorm
with a ``(1 + scale)`` weight; attention with q/k/v biases where the
configuration has them, rotary on the first ``rotary_pct`` of each head
in two halves, causal, over a window of ``window`` positions on
``*_local`` layers, grouped KV heads; the Mamba2 mixer (a causal
depthwise conv of ``d_conv`` taps, SiLU, the selective state space
recurrence ``h_t = exp(dt_t a) h_(t-1) + dt_t x_t B_t``, ``y_t = C_t h_t
+ D x_t``, a gated RMSNorm); a hybrid block's two mixers fused as their
mean; a gated SiLU MLP; a final norm and an untied head.

The state space part runs in float64 in its quadratic form, ``y_t =
sum_(s <= t) (C_t . B_s) exp(A_t - A_s) dt_s x_s`` with ``A`` the
cumulative sum of ``dt a``, so that no chunking or state passing of the
program is repeated here.

``control=True`` rounds both operands of every matrix product to TF32
(10 bits of mantissa, round to nearest even) first: the reference at the
next precision below the configuration's float32 with TF32 off."""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10-bit mantissa, to nearest
    even."""
    b = x.contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    b = (b + 0xFFF + lsb) & ~0x1FFF
    return b.view(torch.float32)


class Plain:
    """The products of one reference pass, plain fp32 or TF32-rounded."""

    def __init__(self, control: bool = False):
        self.control = control

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.control:
            a, b = tf32(a.float()), tf32(b.float())
        return a @ b

    def mm64(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.control:
            a, b = tf32(a.float()), tf32(b.float())
        return a.double() @ b.double()


def rms_norm(x, scale, eps):
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * (1.0 + scale)


def rotary(x, positions, m):
    """x [S, H, hd]: the first ``rotary_pct`` of each head rotated as two
    halves."""
    hd = x.shape[-1]
    d_rot = int(hd * m["rotary_pct"]) // 2 * 2
    half = d_rot // 2
    inv = 1.0 / (m["rope_theta"] ** (torch.arange(
        0, d_rot, 2, dtype=torch.float32, device=x.device) / d_rot))
    ang = positions.to(torch.float32)[:, None] * inv
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:d_rot]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s, x[..., d_rot:]],
                     dim=-1)


def attention(p, h, m, local: bool, pl: Plain, q_block: int = 1024):
    s = h.shape[0]
    hd, nh, nkv = m["head_dim"], m["n_heads"], m["n_kv_heads"]
    q, k, v = (pl.mm(h, p[w]) for w in ("wq", "wk", "wv"))
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    pos = torch.arange(s, device=h.device)
    q = rotary(q.reshape(s, nh, hd), pos, m)
    k = rotary(k.reshape(s, nkv, hd), pos, m)
    v = v.reshape(s, nkv, hd)
    rep = nh // nkv
    k = k.repeat_interleave(rep, dim=1).transpose(0, 1)      # [H, S, hd]
    v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
    q = q.transpose(0, 1) * hd ** -0.5
    out = torch.empty_like(q)
    for a in range(0, s, q_block):
        b = min(s, a + q_block)
        scores = pl.mm(q[:, a:b], k.transpose(1, 2))           # [H, q, S]
        qp = pos[a:b, None]
        ok = pos[None, :] <= qp
        if local:
            ok = ok & (qp - pos[None, :] < m["window"])
        scores = scores.masked_fill(~ok, float("-inf"))
        out[:, a:b] = pl.mm(torch.softmax(scores, dim=-1), v)
    return pl.mm(out.transpose(0, 1).reshape(s, nh * hd), p["wo"])


def mamba(p, h, m, pl: Plain, head_block: int = 8):
    s, d = h.shape
    di = m["expand"] * d
    hp, n, g = m["ssm_headdim"], m["d_state"], m["ssm_ngroups"]
    nh = di // hp
    conv_dim = di + 2 * g * n
    zxbcdt = pl.mm(h, p["in_proj"])
    z, xbc, dt = torch.split(zxbcdt, [di, conv_dim, nh], dim=-1)
    taps = p["conv_w"].shape[1]
    xp = F.pad(xbc, (0, 0, taps - 1, 0))
    xbc = F.silu(sum(xp[j:j + s] * p["conv_w"][:, j] for j in range(taps)))
    x, b, c = torch.split(xbc, [di, g * n, g * n], dim=-1)
    dt = F.softplus(dt + p["dt_bias"]).double()                 # [S, H]
    a = -torch.exp(p["a_log"]).double()                         # [H]
    cum = torch.cumsum(dt * a, dim=0)                           # [S, H]
    xh = x.reshape(s, nh, hp)
    xdt = (xh.double() * dt[..., None])                         # [S, H, P]
    causal = torch.ones((s, s), dtype=torch.bool, device=h.device).tril()
    y = torch.empty((s, nh, hp), dtype=torch.float64, device=h.device)
    per = nh // g
    for gi in range(g):
        cb = pl.mm64(c[:, gi * n:(gi + 1) * n],
                     b[:, gi * n:(gi + 1) * n].t())             # [S, S]
        for h0 in range(gi * per, (gi + 1) * per, head_block):
            h1 = min((gi + 1) * per, h0 + head_block)
            seg = cum[:, None, h0:h1] - cum[None, :, h0:h1]      # [t, s, h]
            decay = torch.where(causal[..., None], torch.exp(
                torch.where(causal[..., None], seg, torch.zeros_like(seg))),
                torch.zeros_like(seg))
            w = (cb[..., None] * decay).permute(2, 0, 1)         # [h, t, s]
            y[:, h0:h1] = torch.stack(
                [pl.mm64(w[j], xdt[:, h0 + j]) for j in range(h1 - h0)],
                dim=1)
    y = y.float() + xh * p["d_skip"][None, :, None]
    y = rms_norm(y.reshape(s, di) * F.silu(z), p["norm_scale"],
                 m["norm_eps"])
    return pl.mm(y, p["out_proj"])


def mlp(p, h, pl: Plain):
    return pl.mm(F.silu(pl.mm(h, p["w_gate"])) * pl.mm(h, p["w_up"]),
                 p["w_down"])


def logits(m: dict, params: dict, tokens: torch.Tensor,
           rows: Sequence[int], control: bool = False) -> torch.Tensor:
    """fp32 logits ``[len(rows), vocab]`` of the positions ``rows`` of
    one sequence ``tokens [S]``, with ``params`` dense fp32 (the
    quantized leaves already the format's matrices)."""
    pl = Plain(control)
    pattern = m["pattern"]
    eps = m["norm_eps"]
    x = params["embed"]["tok"][tokens.long()]
    for layer in range(m["n_layers"]):
        grp, slot = divmod(layer, len(pattern))
        kind = pattern[slot]
        p = {k: ({kk: vv[grp] for kk, vv in v.items()}
                 if isinstance(v, dict) else v[grp])
             for k, v in params["blocks"][f"b{slot}"].items()}
        h = rms_norm(x, p["norm1"], eps)
        mixes = []
        if "attn" in p:
            mixes.append(attention(p["attn"], h, m, kind.endswith("_local"),
                                   pl))
        if "mamba" in p:
            mixes.append(mamba(p["mamba"], h, m, pl))
        x = x + (mixes[0] if len(mixes) == 1
                 else 0.5 * (mixes[0] + mixes[1]))
        if "ffn" in p:
            x = x + mlp(p["ffn"], rms_norm(x, p["norm2"], eps), pl)
    x = rms_norm(x[torch.as_tensor(list(rows), device=x.device)],
                 params["final_norm"], eps)
    return pl.mm(x, params["lm_head"])


def served_gaps(ref: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """Per served token, how far its reference logit lies below the
    reference's best at that position (0 where it is the best)."""
    best = ref.max(dim=-1).values
    return best - ref.gather(1, served.long()[:, None])[:, 0]


def request_readings(m: dict, params: dict, prompt, out_tokens,
                     out_logprobs, control: bool = False) -> dict:
    """One served request against the reference, per served token:
    ``logit_gap`` (``served_gaps``) and ``logprob_err``, the distance of
    the program's logprob of the token from the reference's. With
    ``control``, the same two of the token the TF32 control puts first,
    the control's own logprob against the reference's
    (``control_logit_gap``, ``control_logprob_err``)."""
    dev = params["lm_head"].device
    seq = torch.as_tensor([int(t) for t in prompt]
                          + [int(t) for t in out_tokens[:-1]], device=dev)
    rows = range(len(prompt) - 1, len(seq))
    ref = logits(m, params, seq, rows)
    lp = torch.log_softmax(ref, dim=-1)
    served = torch.as_tensor([int(t) for t in out_tokens], device=dev)
    got = torch.as_tensor([float(x) for x in out_logprobs], device=dev)
    out = {"logit_gap": served_gaps(ref, served),
           "logprob_err": (got - lp.gather(1, served[:, None])[:, 0]).abs()}
    if control:
        low = logits(m, params, seq, rows, control=True)
        tok = low.argmax(dim=-1)
        low_lp = torch.log_softmax(low, dim=-1).gather(1, tok[:, None])[:, 0]
        out["control_logit_gap"] = served_gaps(ref, tok)
        out["control_logprob_err"] = (
            low_lp - lp.gather(1, tok[:, None])[:, 0]).abs()
    return out
