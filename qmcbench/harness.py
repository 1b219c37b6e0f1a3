"""One run of one cell: set-up, the measured window, the per-layer
readings of a traced run, and the comparison that decides ``correct``.

Set-up (``setup_s``, from the process's start): the kernel library
(built into ``build/kernels/<hash>/`` of the checkout on its first run,
loaded after), dense fp32 weights made on the device from the seed,
the port's QMC serving conversion of them, the engine (graphed and
pipelined, fp32 KV pages, TF32 off), and warm-up waves that run every
step width the mix can reach, batched and solo, so that no graph is
captured in the window.

The window: waves of requests, each one list handed to
``ServeEngine.run``, back to back; after the first, a wave starts only
if the mean wave time so far says it ends inside ``seconds``. Rates are
taken over the whole window, tails over all of its requests or gaps.

With ``trace``, the engine's tracer is on in every wave of the window,
so that each wave's rounds are rebuilt; the first ``trace_waves`` waves
also run under ``torch.profiler`` and give the device metrics; the host
metrics and ``mfu`` come from the waves after them, which the profiler
does not slow.

``correct``: after the window, with the program's state freed, a sample
of the finished requests drawn from the seed (the longest among them)
is compared with the plain reference (``reference.py``), which makes
the weights again from the seed and quantizes them with its own copy of
the format (``refquant.py``): the widest gap by which a served token's
reference logit lies below the reference's best, against the
configuration's limit. A graph captured inside the window, or a request
that did not receive its tokens, fails the run too."""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from qmcbench import devtrace, reference, refquant, rounds, traffic, weights
from qmcbench import work
from qmcbench.spec import HERE, ROOT, Cell

if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))


@dataclasses.dataclass
class Wave:
    requests: list
    stats: object
    seconds: float
    traced: bool


@dataclasses.dataclass
class Readings:
    """What the per-layer readers (``layer_metrics/<name>.py``) read."""
    model: dict
    quant: dict
    slots: int
    page: int
    projs: List[work.Proj]
    stats: list                       # every wave's EngineStats
    host_stats: list                  # the waves the profiler did not cover
    host_wall_s: float
    rounds: List[rounds.Round]        # the profiled waves' rounds
    host_rounds: List[rounds.Round]   # the other waves' rounds
    device: Optional[devtrace.DeviceWindow]

    def kernel_seconds(self, names) -> float:
        return sum(s for k, s in self.device.kernel_s.items()
                   if any(n in k for n in names))

    def qmm_roofline(self, route: str, names) -> Optional[float]:
        """Least time of the traced calls that take ``route`` over the
        device time of the kernels ``names`` (None where there are
        none)."""
        if not self.rounds or self.device is None:
            return None
        least = 0.0
        for rd in self.rounds:
            m = rd.rows(self.slots)
            for p in self.projs:
                if not p.quantized:
                    continue
                kind, pad = work.qmm_route(m, p.k, p.n)
                if kind == route:
                    least += p.calls * work.least_s(
                        *work.qmm_call(pad, p, self.quant))
        device = self.kernel_seconds(names)
        if least <= 0 or device <= 0:
            return None
        return 100.0 * least / device


def model_config(config: dict):
    from repro_torch.models.config import ModelConfig
    m = dict(config["model"])
    m["pattern"] = tuple(m["pattern"])
    return ModelConfig(name=config["name"], **m)


def qmc_config(q: dict):
    from repro_torch.core.qconfig import QMCConfig
    lo, hi, n = q["scale_grid"]
    return QMCConfig(rho=q["rho"], bits_in=q["bits_in"],
                     bits_out=q["bits_out"], cell_bits=q["cell_bits"],
                     granularity=q["granularity"],
                     subtile=tuple(q["subtile"]), scale_grid_lo=lo,
                     scale_grid_hi=hi, scale_grid_n=n)


def set_precision(config: dict) -> None:
    tf32 = bool(config["engine"]["allow_tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def requests_of(draws: List[traffic.Draw]):
    """Greedy requests that record each emitted token's logprob (the head
    computes it on every round; the flag only keeps it)."""
    from repro_torch.serve.engine import Request
    from repro_torch.serve.sampling import SamplingParams
    sp = SamplingParams(logprobs=True)
    return [Request(uid=d.uid, prompt=d.prompt.copy(),
                    max_new_tokens=d.max_new, sampling=sp) for d in draws]


def build_engine(cell: Cell, seed: int, device, tracer):
    """The program under test, from the seed's dense weights."""
    from repro_torch.core.serving_quant import quantize_for_serving
    from repro_torch.serve.engine import ServeEngine
    c, t = cell.config, cell.traffic
    cfg = model_config(c)
    dense = weights.dense_params(c["model"], seed, device)
    qparams = quantize_for_serving(dense, qmc_config(c["quant"]),
                                   min_dim=c["quant"]["min_dim"])
    del dense
    e = c["engine"]
    return ServeEngine(
        cfg, qparams, slots=t["slots"], max_len=t["max_len"],
        cache_dtype=getattr(torch, e["kv_dtype"]), page_size=e["page"],
        chunk_tokens=t["chunk"], paged_attention=e["paged_attention"],
        weight_plan=e["weight_plan"], pipelined=e["pipelined"],
        cuda_graphs=e["cuda_graphs"], device=device, tracer=tracer)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_window(eng, cell: Cell, seed: int, seconds: float, trace: bool,
               tracer, device) -> tuple:
    """The measured waves; returns (waves, window seconds, the rounds of
    the profiled waves, those of the others, device window). Starting and
    reading the profiler is left out of the window's clock."""
    t = cell.traffic
    vocab = cell.config["model"]["vocab"]
    n_traced = int(t["trace_waves"]) if trace else 0
    prof = devtrace.Profiler(tracer) if n_traced else None
    waves: List[Wave] = []
    traced_rounds: List[rounds.Round] = []
    host_rounds: List[rounds.Round] = []
    dev = None
    tracer.enabled = trace
    if n_traced:
        prof.start()
        tracer.instant("qmcbench/traced")
    paused = 0.0
    t_w0 = time.perf_counter()
    while True:
        k = len(waves)
        if k:
            elapsed = time.perf_counter() - t_w0 - paused
            if elapsed + elapsed / k > seconds:
                break
        if k == n_traced and prof is not None and dev is None:
            t_p = time.perf_counter()
            dev = _stop(prof, tracer)
            paused += time.perf_counter() - t_p
        draws = traffic.wave(t, vocab, seed, k)
        reqs = requests_of(draws)
        i0 = len(tracer.events)
        t0 = time.perf_counter()
        eng.run(reqs)
        _sync(device)
        dt = time.perf_counter() - t0
        waves.append(Wave(reqs, eng.stats, dt, k < n_traced))
        if trace:
            got = rounds.rebuild(tracer.events[i0:], draws, t["chunk"],
                                 eng.stats)
            (traced_rounds if k < n_traced else host_rounds).extend(got)
            # what the device window reads: the phases and round spans
            tracer.events[i0:] = [e for e in tracer.events[i0:]
                                  if e["ph"] == "X" and k < n_traced]
    window_s = time.perf_counter() - t_w0 - paused
    if prof is not None and dev is None:
        dev = _stop(prof, tracer)
    tracer.enabled = False
    return waves, window_s, traced_rounds, host_rounds, dev


def _stop(prof, tracer) -> devtrace.DeviceWindow:
    """Ends the traced waves: the profiler's device window over them."""
    tracer.instant("qmcbench/traced")
    prof.stop()
    marks = [e["ts"] for e in tracer.events
             if e["ph"] == "i" and e["name"] == "qmcbench/traced"]
    dev = devtrace.read(prof.events(), tracer.events, marks[0], marks[-1])
    tracer.clear()
    return dev


def check_sample(waves: List[Wave], seed: int, want_tokens: int,
                 want_requests: int):
    """The requests the comparison reads: the longest finished request,
    then others in an order drawn from the seed, until ``want_tokens``
    served tokens and ``want_requests`` requests are in."""
    done = [r for w in waves for r in w.requests
            if r.done and len(r.out_tokens) == r.max_new_tokens]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.prompt) + len(r.out_tokens),
                                       -r.uid))
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 7]))
    rest = [done[i] for i in rng.permutation(len(done))
            if done[i] is not longest]
    out, n = [longest], len(longest.out_tokens)
    for r in rest:
        if n >= want_tokens and len(out) >= want_requests:
            break
        out.append(r)
        n += len(r.out_tokens)
    return out


COMPARED = ("logit_gap", "logprob_err")


def compare(cell: Cell, seed: int, sample, device,
            control: bool = False) -> Dict[str, float]:
    """The reference's readings of the sampled requests, each the widest
    over their served tokens: ``logit_gap`` (how far a served token's
    reference logit lies below the reference's best) and
    ``logprob_err`` (how far the program's logprob of it lies from the
    reference's); with ``control`` also the control's two."""
    c = cell.config
    params = refquant.format_params(
        weights.dense_params(c["model"], seed, device), c["quant"])
    out: Dict[str, float] = {}
    with torch.no_grad():
        for r in sample:
            got = reference.request_readings(
                c["model"], params, r.prompt, r.out_tokens, r.out_logprobs,
                control=control)
            for k, v in got.items():
                out[k] = max(out.get(k, 0.0), float(v.max()))
    out["compared_tokens"] = float(sum(len(r.out_tokens) for r in sample))
    return out


def load_reader(name: str):
    path = HERE / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"qmcbench_layer_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def percentile(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: Optional[float] = None) -> dict:
    """One run; the result's dict (see ``run.py``)."""
    from repro_torch.obs.trace import Tracer
    t_start = time.monotonic() if t_start is None else t_start
    c, t = cell.config, cell.traffic
    cuda = torch.device(device).type == "cuda"
    set_precision(c)
    marks = [("start", time.monotonic())]
    if cuda:
        from repro_torch.kernels import build
        build.library()
    marks.append(("kernels", time.monotonic()))
    tracer = Tracer(enabled=False)
    eng = build_engine(cell, seed, device, tracer)
    _sync(device)
    marks.append(("weights+ptq+engine", time.monotonic()))
    for draws in traffic.warmup_waves(work.width_ladder(t["chunk"]),
                                      c["model"]["vocab"]):
        eng.run(requests_of(draws))
    _sync(device)
    marks.append(("warm-up", time.monotonic()))
    setup_s = time.monotonic() - t_start
    print("setup " + " ".join(
        f"{name} {b - a:.3f}" for (_, a), (name, b) in zip(marks, marks[1:]))
        + f" (imports {marks[0][1] - t_start:.3f})", file=sys.stderr)

    waves, window_s, traced_rounds, host_rounds, dev = run_window(
        eng, cell, seed, seconds, trace, tracer, device)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    stats = [w.stats for w in waves]
    print(f"waves {len(waves)} traced {sum(w.traced for w in waves)} "
          "seconds " + " ".join(f"{w.seconds:.3f}" for w in waves)
          + f" window {window_s:.3f}", flush=True)
    if traced_rounds:
        widths: Dict[str, int] = {}
        for rd in traced_rounds:
            key = f"{rd.c}{'s' if rd.solo else ''}"
            widths[key] = widths.get(key, 0) + 1
        print("traced rounds by width (s: solo) " + " ".join(
            f"{k}:{v}" for k, v in sorted(
                widths.items(), key=lambda kv: int(kv[0].rstrip("s")))),
            file=sys.stderr)

    captures = sum(s.graph_captures for s in stats)
    unfinished = sum(1 for w in waves for r in w.requests
                     if len(r.out_tokens) != r.max_new_tokens)
    attempted = sum(len(w.requests) for w in waves)
    if trace:
        host = [w for w in waves if not w.traced] or waves
        readings = Readings(
            model=c["model"], quant=c["quant"], slots=t["slots"],
            page=c["engine"]["page"],
            projs=work.projections(c["model"], c["quant"]), stats=stats,
            host_stats=[w.stats for w in host],
            host_wall_s=sum(w.seconds for w in host), rounds=traced_rounds,
            host_rounds=host_rounds if any(not w.traced for w in waves)
            else traced_rounds, device=dev)
        metrics = {}
        for m in cell.per_layer:
            v = load_reader(m["name"])(readings)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = {
            "output_tok_s": lambda: sum(s.tokens_out for s in stats)
            / window_s,
            "itl_p95_ms": lambda: 1e3 * percentile(
                [g for s in stats for g in s.itl_s()], 95),
            "ttft_p95_s": lambda: percentile(
                [x for s in stats for x in s.ttft_s], 95),
            "setup_s": lambda: setup_s,
        }
        metrics = {m["name"]: {"value": e2e[m["name"]](), "unit": m["unit"]}
                   for m in cell.end_to_end}

    sample = check_sample(waves, seed, int(t["check_tokens"]),
                          int(t["check_requests"]))
    del eng
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.monotonic()
    readings_c = compare(cell, seed, sample, device) if sample else {
        "logit_gap": float("inf"), "logprob_err": float("inf"),
        "compared_tokens": 0.0}
    print(f"reference: {len(sample)} requests, "
          f"{readings_c['compared_tokens']:.0f} served tokens, "
          f"{time.monotonic() - t_ref:.3f} s", file=sys.stderr)
    checks = {name: (readings_c[name], c["correct"][name])
              for name in COMPARED}
    checks.update({
        "window_graph_captures": (captures, 0),
        "unfinished_requests": (unfinished, 0),
    })
    correct = all(v <= lim for v, lim in checks.values())
    for name, (v, lim) in checks.items():
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": unfinished, "metrics": metrics,
              "device": device_info(cuda, peak)}
    if trace and dev is not None:
        result["device"].update(busy_s=dev.busy_s, window_s=dev.window_s)
        result["breakdown"] = {
            "device_ops": [[k[:160], v] for k, v in sorted(
                dev.kernel_s.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[k, v] for k, v in sorted(
                dev.idle_by_phase.items(), key=lambda kv: -kv[1])[:10]]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def device_info(cuda: bool, peak: int) -> dict:
    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(peak)}

