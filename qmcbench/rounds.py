"""Each round of a wave, rebuilt from what the harness knows (the wave's
requests) and what the engine's tracer recorded (one ``round`` span per
round with its lane counts, ``req/chunk_done`` with each prefill chunk's
end position, ``req/first_token``), with the frozen width rule. Nothing
is guessed: a rebuild that disagrees with the engine's own counters
(``EngineStats``) raises.

A round's step runs ``[slots, C]`` rows, or ``[1, C]`` on the solo lane
when exactly one lane is live; ``C`` is 1 for pure decode, else the
smallest rung of the width ladder that covers the widest chunk. A decode
lane's ``k``-th decode round (from 0) writes position ``prompt + k``;
a request decodes in every round from the one after its first token
until it has its output, except in rounds that hold a prefill chunk on
a stack that does not co-schedule them (its span then counts 0 decode
lanes)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from qmcbench import work


class Mismatch(RuntimeError):
    """The rebuilt rounds disagree with the engine's counters."""


@dataclasses.dataclass
class Round:
    t0_us: float
    dur_us: float
    c: int
    prefill: List[work.Lane]     # this round's prefill chunks
    decode: List[work.Lane]      # its decode lanes, one token each
    emitting: int                # lanes that emit a token this round

    @property
    def lanes(self) -> List[work.Lane]:
        return self.prefill + self.decode

    @property
    def solo(self) -> bool:
        return len(self.prefill) + len(self.decode) == 1

    def rows(self, slots: int) -> int:
        """Rows of the step's products: ``[slots, C]``, or ``[1, C]`` on
        the solo lane."""
        return self.c * (1 if self.solo else slots)


def rebuild(events: List[dict], draws, chunk: int, stats) -> List[Round]:
    """The rounds of one wave (one ``ServeEngine.run``), from its tracer
    ``events`` and ``draws`` (``traffic.Draw``), checked against its
    ``stats``."""
    plen = {d.uid: len(d.prompt) for d in draws}
    max_new = {d.uid: d.max_new for d in draws}
    spans = sorted((e for e in events
                    if e["ph"] == "X" and e["name"] == "round"),
                   key=lambda e: e["ts"])
    chunks = sorted((e for e in events
                     if e["ph"] == "i" and e["name"] == "req/chunk_done"),
                    key=lambda e: e["ts"])
    first = {e["args"]["uid"]: e["ts"] for e in events
             if e["ph"] == "i" and e["name"] == "req/first_token"}
    done_pos: Dict[int, int] = {}
    decoded: Dict[int, int] = {}
    out: List[Round] = []
    ci = 0
    for sp in spans:
        t0, t1 = sp["ts"], sp["ts"] + sp["dur"]
        args = sp["args"]
        prefill: List[work.Lane] = []
        finishing = 0
        while ci < len(chunks) and chunks[ci]["ts"] <= t1:
            a = chunks[ci]["args"]
            uid, pos = a["uid"], a["pos"]
            p0 = done_pos.get(uid, 0)
            prefill.append(work.Lane(p0, pos - p0))
            done_pos[uid] = pos
            finishing += pos == plen[uid]
            ci += 1
        if len(prefill) != args["prefill_lanes"]:
            raise Mismatch(f"round at {t0:.0f} us: {len(prefill)} chunks, "
                           f"its span says {args['prefill_lanes']}")
        ready = sorted(u for u, ts in first.items()
                       if ts < t0 and decoded.get(u, 0) < max_new[u] - 1)
        if args["decode_lanes"] not in (0, len(ready)):
            raise Mismatch(f"round at {t0:.0f} us: {len(ready)} lanes can "
                           f"decode, its span says {args['decode_lanes']}")
        decode: List[work.Lane] = []
        if args["decode_lanes"]:
            for u in ready:
                k = decoded.get(u, 0)
                decode.append(work.Lane(plen[u] + k, 1))
                decoded[u] = k + 1
        widest = max((ln.n for ln in prefill), default=0)
        out.append(Round(t0, sp["dur"], work.step_width(widest, chunk),
                         prefill, decode, finishing + len(decode)))
    check(out, stats)
    return out


def check(rounds: List[Round], stats) -> None:
    """The engine's counters against the rebuilt rounds."""
    got = {
        "rounds": len(rounds),
        "prefill_chunks": sum(len(r.prefill) for r in rounds),
        "decode_steps": sum(1 for r in rounds if r.decode),
        "solo_rounds": sum(r.solo for r in rounds),
        "prefill_tokens": sum(ln.n for r in rounds for ln in r.prefill),
        "prefill_tokens_padded": sum(r.c * len(r.prefill) for r in rounds),
        "tokens_out": sum(r.emitting for r in rounds),
    }
    want = {k: getattr(stats, k) for k in got}
    if got != want:
        raise Mismatch(f"rebuilt {got}, the engine counted {want}")
