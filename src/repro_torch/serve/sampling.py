"""Token selection inside the serving step (counterpart of
``repro.serve.sampling``).

Contract (the JAX head's, integer for integer):

  * **Greedy is the oracle.** A lane with ``temperature <= 0`` takes
    ``argmax(logits)`` (the first maximal index, as ``jnp.argmax``).
  * **Sampling** (``temperature > 0``): logits are scaled by
    ``1/temperature``, masked by top-k (keep the k highest; 0 = off) and
    top-p (keep the smallest set whose cumulative mass reaches ``p``,
    always at least the top token; 1.0 = off; both masks taken on the
    scaled logits and intersected), then drawn as ``argmax(masked +
    gumbel)``, as ``jax.random.categorical`` draws.
  * **PRNG keys** are the JAX package's threefry2x32 keys, reproduced bit
    for bit: the engine derives one key per request,
    ``fold_in_str(PRNGKey(seed), f"req/{uid}")`` (:func:`request_key`),
    and the head folds each token's absolute position in per column, so a
    token's draw depends only on ``(seed, uid, position)``: solo vs
    batched rounds, preemption recompute and the pipelined loop's
    on-device token carry all draw the same stream. The random bits of a
    ``(V,)`` draw are those of ``jax.random.bits`` with
    ``jax_threefry_partitionable`` on (jax 0.9's default): ``out1 ^ out2``
    of threefry2x32 over the counters ``(0, i)``, ``i < V``.
  * **Logprobs** are the model's log-softmax at the selected token
    (temperature-independent), for greedy and sampled lanes alike.
  * **Dead lanes read a sentinel.** Columns at or past ``n_new[b]`` return
    :data:`DEAD_TOKEN` = -1, an id no vocab contains.

The head runs on the device inside the captured step: it reads nothing
back to the host (no ``.item()``, no data-dependent shapes) and draws
with threefry, never with torch's own generator. The 32-bit words are
held in int32 tensors: additions wrap, and right shifts are masked to
make them logical. The sampled branch works on blocks of at most
``2**22`` logits (41 rows of a 100,352-token vocab), so its temporaries
stay bounded at any step width.
"""
from __future__ import annotations

import dataclasses
import functools
import zlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

DEAD_TOKEN = -1

# the sampled branch handles rows of [B * C, V] logits in blocks of at most
# this many elements
_BLOCK_ELEMS = 1 << 22
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_TINY = float(np.finfo(np.float32).tiny)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request token-selection policy (greedy by default).

    ``top_k=0`` / ``top_p=1.0`` disable those filters; ``seed`` roots the
    request's stream (folded with the request uid and each token's
    position); ``logprobs=True`` asks the engine to record the selected
    token's model logprob in ``Request.out_logprobs``."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    logprobs: bool = False

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got "
                             f"{self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")


GREEDY = SamplingParams()


# ---------------------------------------------------------------------------
# threefry2x32 on int32 tensors holding uint32 bits
# ---------------------------------------------------------------------------
def _u32(x: int) -> int:
    """A uint32 value as the int32 with the same bits."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= 1 << 31 else x


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    low = torch.bitwise_and(torch.bitwise_right_shift(x, 32 - r),
                            (1 << r) - 1)
    return torch.bitwise_or(torch.bitwise_left_shift(x, r), low)


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 block function (20 rounds) on int32 tensors that
    hold uint32 bits; all four broadcast together. Returns the two output
    words, as ``jax.random``'s primitive does."""
    ks = [k1, k2, torch.bitwise_xor(torch.bitwise_xor(k1, k2),
                                    _u32(_KS_PARITY))]
    x = [x1 + ks[0], x2 + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = torch.bitwise_xor(x[0], _rotl(x[1], r))
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + (i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as ``[2] uint32``. The reference runs
    with 64-bit mode off, so the seed is first truncated to its low 32
    bits and the high word is 0."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def _as_i32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32))


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` on the host: threefry2x32 of the
    counters ``(0, data)`` under ``key``."""
    k = _as_i32(key)
    o1, o2 = threefry2x32(k[0], k[1], torch.zeros((), dtype=torch.int32),
                          torch.tensor(_u32(int(data)), dtype=torch.int32))
    return np.array([int(o1), int(o2)], np.int64).astype(
        np.int32).view(np.uint32)


def fold_in_str(key: np.ndarray, s: str) -> np.ndarray:
    """Fold a string into a key (the JAX package's idiom): the crc32 of
    its UTF-8 bytes."""
    return fold_in(key, zlib.crc32(s.encode("utf-8")))


@functools.lru_cache(maxsize=4096)
def _request_key(seed: int, uid: int) -> Tuple[int, int]:
    return tuple(int(v) for v in fold_in_str(prng_key(seed), f"req/{uid}"))


def request_key(seed: int, uid: int) -> np.ndarray:
    """Per-request key ``[2] uint32``: the seed's key with ``req/<uid>``
    folded in. Depends only on (seed, uid), so a preempted request draws
    its exact stream again on recompute."""
    return np.array(_request_key(int(seed), int(uid)), np.uint32)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` for each row of ``keys [R, 2]``
    (int32 holding uint32 bits): ``[R, n]`` int32 holding uint32 bits."""
    counts = torch.arange(n, dtype=torch.int32, device=keys.device)[None, :]
    o1, o2 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(counts),
                          counts)
    return torch.bitwise_xor(o1, o2)


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(..., minval=tiny, maxval=1)`` from its bits:
    the top 23 bits as the mantissa of a float in [1, 2), minus 1, moved
    up to at least the smallest normal float."""
    mant = torch.bitwise_and(torch.bitwise_right_shift(bits, 9), 0x7FFFFF)
    f = torch.bitwise_or(mant, 0x3F800000).view(torch.float32) - 1.0
    # the scale (1 - tiny) rounds to 1.0 in float32
    return torch.clamp_min(f + _TINY, _TINY)


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.gumbel`` in its "low" mode: ``-log(-log(u))``."""
    return -torch.log(-torch.log(uniform_from_bits(bits)))


def lane_inputs(n: int) -> Dict[str, np.ndarray]:
    """Greedy host-side per-lane sampling arrays (lane ``b`` holds its
    request's :class:`SamplingParams` fields)."""
    return {"temp": np.zeros(n, np.float32),
            "top_k": np.zeros(n, np.int32),
            "top_p": np.ones(n, np.float32),
            "key": np.zeros((n, 2), np.uint32)}


def set_lane(samp: Dict[str, np.ndarray], lane: int,
             sp: Optional[SamplingParams], uid: int = 0) -> None:
    """Write one request's params into its lane of a :func:`lane_inputs`
    table (``sp=None`` resets the lane to greedy)."""
    sp = sp or GREEDY
    samp["temp"][lane] = sp.temperature
    samp["top_k"][lane] = sp.top_k
    samp["top_p"][lane] = sp.top_p
    samp["key"][lane] = (request_key(sp.seed, uid) if sp.temperature > 0
                         else 0)


# ---------------------------------------------------------------------------
# the head
# ---------------------------------------------------------------------------
def _sample_rows(lg: torch.Tensor, t: torch.Tensor, k: torch.Tensor,
                 p: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """One block of the sampled branch: ``lg [R, V]`` and per-row ``t``,
    ``k``, ``p`` ``[R]`` and ``keys [R, 2]`` -> tokens ``[R]`` int64."""
    v = lg.shape[-1]
    scaled = lg.to(torch.float32) / torch.clamp_min(t, 1e-6)[:, None]
    asc, _ = torch.sort(scaled, dim=-1)
    kk = torch.clamp(k, 1, v).to(torch.int64)
    kth = torch.gather(asc, -1, (v - kk)[:, None])
    keep = (scaled >= kth) | (k <= 0)[:, None]
    desc = torch.flip(asc, (-1,))
    cum = torch.cumsum(torch.softmax(desc, dim=-1), dim=-1)
    n_keep = torch.sum(cum < p[:, None], dim=-1) + 1
    # n_keep can pass v only when p rounds above the whole mass (p = 1,
    # where the mask is off anyway): clamp so the gather stays in range
    pth = torch.gather(desc, -1, torch.clamp_max(n_keep - 1, v - 1)[:, None])
    keep &= (scaled >= pth) | (p >= 1.0)[:, None]
    masked = torch.where(keep, scaled, torch.full_like(scaled, -torch.inf))
    return torch.argmax(masked + gumbel_from_bits(random_bits(keys, v)),
                        dim=-1)


def select_tokens(logits: torch.Tensor, temp: torch.Tensor,
                  top_k: torch.Tensor, top_p: torch.Tensor,
                  key: torch.Tensor, positions: torch.Tensor,
                  n_new: torch.Tensor, *, sampled: bool = True):
    """The token-selection epilogue of the serving step.

    ``logits [B, C, V]``; ``temp``/``top_k``/``top_p`` ``[B]`` lane
    params; ``key [B, 2]`` per-request key bits (int32 holding uint32);
    ``positions [B, C]`` absolute positions, folded into the per-column
    keys; ``n_new [B]`` live-column counts. Returns ``(tokens [B, C]
    int32, logprobs [B, C] float32)`` with dead columns at
    :data:`DEAD_TOKEN` / 0.0.

    ``sampled=False`` is the caller's promise that no lane samples (every
    ``temp <= 0``): the sampled branch is left out, and the result is the
    one the full head gives for all-greedy lanes, bit for bit."""
    b, c, v = logits.shape
    dev = logits.device
    tok = torch.argmax(logits, dim=-1)
    if sampled:
        rows = b * c

        def per_row(x):
            return x.to(dev)[:, None].expand(b, c).reshape(rows)

        kd = key.to(dev)[:, None, :].expand(b, c, 2).reshape(rows, 2)
        pos = positions.to(dev, torch.int32).reshape(rows)
        k1, k2 = threefry2x32(kd[:, 0], kd[:, 1], torch.zeros_like(pos), pos)
        keys = torch.stack([k1, k2], dim=-1)
        t_r, k_r, p_r = per_row(temp), per_row(top_k), per_row(top_p)
        flat = logits.reshape(rows, v)
        step = max(1, _BLOCK_ELEMS // v)
        drawn = torch.empty(rows, dtype=torch.int64, device=dev)
        for r0 in range(0, rows, step):
            sl = slice(r0, min(rows, r0 + step))
            drawn[sl] = _sample_rows(flat[sl], t_r[sl], k_r[sl], p_r[sl],
                                     keys[sl])
        hot = (temp.to(dev) > 0.0)[:, None]
        tok = torch.where(hot, drawn.view(b, c), tok)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    logp = torch.gather(logp, -1, tok[..., None])[..., 0]
    cols = torch.arange(c, device=dev)[None, :]
    live = cols < n_new[:, None].to(dev)
    return (torch.where(live, tok, torch.full_like(tok, DEAD_TOKEN))
            .to(torch.int32),
            torch.where(live, logp, torch.zeros_like(logp)))


def select_tokens_tp(logits: torch.Tensor, vocab: int, temp: torch.Tensor,
                     top_k: torch.Tensor, top_p: torch.Tensor,
                     key: torch.Tensor, positions: torch.Tensor,
                     n_new: torch.Tensor, mesh, *, sampled: bool = True):
    """``select_tokens`` over a vocab-parallel head: ``logits [B, C,
    V / M]`` hold this rank's slice of the ``vocab`` (model rank ``m``
    the ids ``[m V / M, (m + 1) V / M)``). Every rank returns the same
    ``(tokens, logprobs)``.

    Greedy (``sampled=False``) reduces across the model group: the max
    logit (all_reduce MAX), the lowest id that reaches it (all_reduce MIN
    of each rank's first argmax, so ties go to the lowest index, as
    ``argmax`` has them), and the softmax sum at that max (all_reduce
    SUM); the logprob is ``-log(sum)``, the selected logit being the
    max. With a sampled lane the logits rows are gathered whole (one
    all_reduce SUM of the slices in zeros, exact) and ``select_tokens``
    runs on them, so a draw sees the vocab it sees on one rank."""
    b, c, vl = logits.shape
    m = mesh.index("model")
    if sampled:
        full = torch.zeros((b, c, vocab), dtype=logits.dtype,
                           device=logits.device)
        full[..., m * vl:(m + 1) * vl] = logits
        mesh.all_reduce(full, "model", kind="head")
        return select_tokens(full, temp, top_k, top_p, key, positions,
                             n_new, sampled=True)
    lf = logits.to(torch.float32)
    mx, idx = torch.max(lf, dim=-1)
    gmax = mesh.all_reduce(mx.clone(), "model", "max", kind="head")
    cand = torch.where(mx == gmax, idx + m * vl,
                       torch.full_like(idx, vocab))
    tok = mesh.all_reduce(cand, "model", "min", kind="head")
    ssum = mesh.all_reduce(torch.exp(lf - gmax[..., None]).sum(-1),
                           "model", kind="head")
    logp = -torch.log(ssum)
    dev = logits.device
    cols = torch.arange(c, device=dev)[None, :]
    live = cols < n_new[:, None].to(dev)
    return (torch.where(live, tok, torch.full_like(tok, DEAD_TOKEN))
            .to(torch.int32),
            torch.where(live, logp, torch.zeros_like(logp)))
