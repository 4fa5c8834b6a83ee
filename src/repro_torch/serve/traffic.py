"""Open-loop traffic driver for the simulated serving stack.

Arrivals are generated up front (Poisson or an explicit trace) and
*never* throttled by the server — the open-loop discipline tail-latency
measurement requires: at overload the queue grows and per-request
latency diverges, which is exactly the goodput-vs-load knee
``BENCH_serve.json`` reports.  The replay itself is a continuous-batching
loop over slots whose per-step cost comes from a pluggable
``step_time(nd, npf, kvb, step) -> us`` — a :class:`~repro_torch.serve.sim
.StepTable` lookup on the batched lane, a rebind + ``run_program`` call
on the per-step lane — so the two lanes share every line of queueing
logic and lane agreement reduces to executor agreement.

Timestamps per request (all microseconds, simulated): ``arrive`` (enters
the queue), ``admit`` (a slot picks it up, FIFO), ``first`` (first output
token — end of the step that finishes its prefill), ``done`` (last
token).  Latency is ``done - arrive``; TTFT is ``first - arrive``.

The port's copy of the reference's ``repro.serve.traffic``, whole: the same
names, layout and float arithmetic, with its imports rewritten to
``repro_torch``. ``tests/test_torch_serve_sim.py`` holds the two equal.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np


@dataclasses.dataclass(frozen=True)
class Workload:
    """One open-loop request trace (arrival times sorted ascending)."""
    arrive_us: np.ndarray
    prompt_tokens: np.ndarray
    out_tokens: np.ndarray

    def __post_init__(self):
        n = len(self.arrive_us)
        if len(self.prompt_tokens) != n or len(self.out_tokens) != n:
            raise ValueError("workload arrays disagree on length")
        if n and np.any(np.diff(self.arrive_us) < 0):
            raise ValueError("arrivals must be sorted ascending")
        if n and (np.any(self.prompt_tokens < 1)
                  or np.any(self.out_tokens < 1)):
            raise ValueError("prompt/output token counts must be >= 1")

    @property
    def n(self) -> int:
        return len(self.arrive_us)


def poisson_workload(rate_rps: float, n_requests: int, rng, *,
                     prompt_tokens: int = 128, out_tokens: int = 32,
                     length_jitter: float = 0.5) -> Workload:
    """Poisson arrivals at ``rate_rps`` with geometric-ish length mix:
    prompt/output lengths drawn uniform in ``mean * (1 +/- jitter)``
    (clipped to >= 1), the load mix a serving study sweeps."""
    rng = np.random.default_rng(rng)
    gaps = rng.exponential(1e6 / rate_rps, n_requests)
    arrive = np.cumsum(gaps) - gaps[0] if n_requests else np.zeros(0)

    def lengths(mean: int) -> np.ndarray:
        lo = max(1, int(round(mean * (1.0 - length_jitter))))
        hi = max(lo, int(round(mean * (1.0 + length_jitter))))
        return rng.integers(lo, hi + 1, n_requests)

    return Workload(arrive_us=arrive, prompt_tokens=lengths(prompt_tokens),
                    out_tokens=lengths(out_tokens))


def trace_workload(arrive_us, prompt_tokens, out_tokens) -> Workload:
    """An explicit request trace (replayed as-is, open loop)."""
    return Workload(arrive_us=np.asarray(arrive_us, dtype=np.float64),
                    prompt_tokens=np.asarray(prompt_tokens, dtype=np.int64),
                    out_tokens=np.asarray(out_tokens, dtype=np.int64))


@dataclasses.dataclass
class ReplayResult:
    """Per-request timestamps plus aggregate counters for one replay."""
    arrive_us: np.ndarray
    admit_us: np.ndarray
    first_us: np.ndarray
    done_us: np.ndarray
    n_steps: int
    sim_us: float                 #: completion time of the last request
    tokens_out: int

    @property
    def latency_us(self) -> np.ndarray:
        return self.done_us - self.arrive_us

    @property
    def ttft_us(self) -> np.ndarray:
        return self.first_us - self.arrive_us

    @property
    def queue_us(self) -> np.ndarray:
        return self.admit_us - self.arrive_us


def replay(workload: Workload, *, slots: int, prefill_chunk: int,
           window: int, kv_bucket, step_time) -> ReplayResult:
    """Continuous-batching open-loop replay.

    Each step: ingest arrivals, FIFO-admit into free slots, charge
    ``step_time(n_decode, n_prefill, kv_bucket, step_idx)``, then advance
    every occupied slot — prefilling slots by one ``prefill_chunk``
    (finishing prompts emit their first output token at the end of that
    step), decoding slots by one token.  A request completes after
    ``out_tokens`` outputs or when its KV hits ``window``.  When the
    machine is idle and requests are still due, the clock jumps to the
    next arrival.
    """
    n = workload.n
    arrive = workload.arrive_us
    admit = np.full(n, np.nan)
    first = np.full(n, np.nan)
    done = np.full(n, np.nan)
    queue: deque = deque()
    # slot state: rid, prefill_left, kv, out_left  (rid < 0 == free)
    s_rid = np.full(slots, -1, dtype=np.int64)
    s_pre = np.zeros(slots, dtype=np.int64)
    s_kv = np.zeros(slots, dtype=np.int64)
    s_out = np.zeros(slots, dtype=np.int64)
    t = 0.0
    next_arr = 0
    completed = 0
    n_steps = 0
    tokens_out = 0
    while completed < n:
        while next_arr < n and arrive[next_arr] <= t:
            queue.append(next_arr)
            next_arr += 1
        busy = s_rid >= 0
        if not queue and not busy.any():
            t = float(arrive[next_arr])  # idle: jump to the next arrival
            continue
        for s in np.flatnonzero(~busy):
            if not queue:
                break
            rid = queue.popleft()
            s_rid[s] = rid
            s_pre[s] = workload.prompt_tokens[rid]
            s_kv[s] = 0
            s_out[s] = workload.out_tokens[rid]
            admit[rid] = t
        busy = s_rid >= 0
        pre = busy & (s_pre > 0)
        dec = busy & (s_pre == 0)
        nd, npf = int(dec.sum()), int(pre.sum())
        kvb = kv_bucket(float(s_kv[dec].mean())) if nd else 0
        t += float(step_time(nd, npf, kvb, n_steps))
        n_steps += 1
        for s in np.flatnonzero(pre):
            take = min(prefill_chunk, int(s_pre[s]))
            s_pre[s] -= take
            s_kv[s] += take
            if s_pre[s] == 0:       # final chunk emits the first token
                rid = int(s_rid[s])
                first[rid] = t
                s_out[s] -= 1
                tokens_out += 1
        for s in np.flatnonzero(dec):
            s_kv[s] += 1
            s_out[s] -= 1
            tokens_out += 1
        for s in np.flatnonzero(busy):
            if s_out[s] <= 0 or s_kv[s] >= window:
                rid = int(s_rid[s])
                if np.isnan(first[rid]):
                    first[rid] = t
                done[rid] = t
                s_rid[s] = -1
                completed += 1
    return ReplayResult(arrive_us=arrive, admit_us=admit, first_us=first,
                        done_us=done, n_steps=n_steps,
                        sim_us=float(np.nanmax(done) if n else 0.0),
                        tokens_out=tokens_out)


# ---------------------------------------------------------------- analysis
def quantiles(values, qs=(0.5, 0.9, 0.99, 0.999)) -> dict:
    """Named latency quantiles (``p50``, ``p99``, ``p999``, ...) of a
    sample, plus mean/max — the CDF summary every BENCH_serve row
    carries."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    out = {}
    for q in qs:
        key = ("p%g" % (100 * q)).replace(".", "")
        out[key] = float(np.quantile(v, q)) if v.size else float("nan")
    out["mean"] = float(v.mean()) if v.size else float("nan")
    out["max"] = float(v.max()) if v.size else float("nan")
    return out


def cdf_points(values, n_points: int = 64) -> list:
    """Downsampled empirical CDF as [value, cumulative_fraction] pairs
    (evenly spaced in rank, endpoints included) — enough to plot the
    tail without shipping every sample."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    if not v.size:
        return []
    idx = np.unique(np.linspace(0, v.size - 1,
                                min(n_points, v.size)).astype(np.int64))
    return [[float(v[i]), float((i + 1) / v.size)] for i in idx]


def knee_point(offered_rps, goodput_rps, frac: float = 0.95):
    """The goodput-vs-load knee: the largest offered load still served
    at >= ``frac`` of the offered rate (None when even the lightest
    point saturates).  Past the knee the open-loop queue diverges and
    tail latency is unbounded — the capacity number a serving study
    quotes."""
    best = None
    for off, good in zip(offered_rps, goodput_rps):
        if good >= frac * off and (best is None or off > best):
            best = float(off)
    return best
