"""Synthetic serving workloads matching the paper's evaluation datasets.

A copy of ``repro.data.workload``: the port keeps its own so that it imports
nothing of the JAX package.

The paper samples ShareGPT (user/ChatGPT conversations) and Azure LLM
production traces; Fig. 11 reports Azure's inputs are 5.21x longer and
outputs 1.66x longer on average than ShareGPT's.  We synthesize log-normal
length distributions with those ratios and Poisson arrivals ("We mimic the
cloud service scenario and generate request arrival times using Poisson
distribution", §4.1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class WorkloadSpec:
    name: str
    mean_input: float
    mean_output: float
    sigma: float = 0.9
    max_input: int = 32768
    max_output: int = 4096


SHAREGPT = WorkloadSpec("sharegpt", mean_input=330.0, mean_output=240.0)
AZURE = WorkloadSpec("azure", mean_input=330.0 * 5.21,
                     mean_output=240.0 * 1.66)

_SPECS = {"sharegpt": SHAREGPT, "azure": AZURE}


def get_workload(name: str) -> WorkloadSpec:
    return _SPECS[name]


def _lognormal(rng: np.random.Generator, mean: float, sigma: float,
               size: int) -> np.ndarray:
    mu = np.log(mean) - sigma**2 / 2.0
    return rng.lognormal(mu, sigma, size)


def sample_requests(
    spec: WorkloadSpec,
    num_requests: int,
    request_rate: float,
    *,
    seed: int = 0,
    vocab: int = 32000,
) -> List[Tuple[float, List[int], int]]:
    """Returns [(arrival_time, prompt_token_ids, output_len)] with Poisson
    arrivals at `request_rate` req/s."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / max(request_rate, 1e-9), num_requests)
    arrivals = np.cumsum(gaps)
    in_lens = np.clip(_lognormal(rng, spec.mean_input, spec.sigma,
                                 num_requests), 4, spec.max_input).astype(int)
    out_lens = np.clip(_lognormal(rng, spec.mean_output, spec.sigma,
                                  num_requests), 1, spec.max_output).astype(int)
    out = []
    for t, li, lo in zip(arrivals, in_lens, out_lens):
        prompt = rng.integers(0, vocab, int(li)).tolist()
        out.append((float(t), prompt, int(lo)))
    return out


# ---------------------------------------------------------------------------
# Prefix-heavy workloads (cross-request KV reuse)
#
# At production scale most traffic shares prefixes: every request from an
# application carries the same system prompt / few-shot template, and every
# turn of a conversation re-sends the whole history.  These generators model
# the two shapes so prefix caching and cache-aware routing have a measurable
# workload (benchmarks/fig_prefix_cache.py).
# ---------------------------------------------------------------------------

def shared_prefix_requests(
    num_requests: int,
    request_rate: float,
    *,
    num_pools: int = 4,
    prefix_len: int = 256,
    mean_suffix: float = 64.0,
    mean_output: float = 48.0,
    sigma: float = 0.6,
    max_suffix: int = 2048,
    max_output: int = 512,
    seed: int = 0,
    vocab: int = 32000,
) -> List[Tuple[float, List[int], int]]:
    """Shared-system-prompt pools: each request draws one of `num_pools`
    fixed `prefix_len`-token prefixes (an application's system prompt +
    few-shot template) followed by a fresh log-normal suffix (the user
    turn).  Poisson arrivals at `request_rate` req/s.

    Every request after the first in a pool can reuse `prefix_len` tokens
    of prefill if it lands on a replica that already served that pool —
    exactly the affinity signal cache-aware routing exploits."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, vocab, prefix_len).tolist()
                for _ in range(num_pools)]
    gaps = rng.exponential(1.0 / max(request_rate, 1e-9), num_requests)
    arrivals = np.cumsum(gaps)
    pools = rng.integers(0, num_pools, num_requests)
    suf_lens = np.clip(_lognormal(rng, mean_suffix, sigma, num_requests),
                       1, max_suffix).astype(int)
    out_lens = np.clip(_lognormal(rng, mean_output, sigma, num_requests),
                       1, max_output).astype(int)
    out = []
    for t, p, ls, lo in zip(arrivals, pools, suf_lens, out_lens):
        suffix = rng.integers(0, vocab, int(ls)).tolist()
        out.append((float(t), prefixes[int(p)] + suffix, int(lo)))
    return out


def _thinned_arrivals(rng: np.random.Generator, rate_fn, peak_rate: float,
                      duration: float) -> List[float]:
    """Non-homogeneous Poisson arrivals over [0, duration) by thinning: draw
    candidates at the constant `peak_rate` envelope, keep each candidate at
    time t with probability rate_fn(t)/peak_rate."""
    out: List[float] = []
    t = 0.0
    inv = 1.0 / max(peak_rate, 1e-9)
    while True:
        t += float(rng.exponential(inv))
        if t >= duration:
            return out
        if rng.random() * peak_rate < rate_fn(t):
            out.append(t)


def diurnal_requests(
    duration: float,
    *,
    base_rate: float,
    peak_rate: float,
    period: Optional[float] = None,
    mean_input: float = 64.0,
    mean_output: float = 32.0,
    sigma: float = 0.6,
    max_input: int = 2048,
    max_output: int = 512,
    seed: int = 0,
    vocab: int = 32000,
) -> List[Tuple[float, List[int], int]]:
    """Diurnal load: the arrival rate follows one (by default) full sinusoid
    cycle between `base_rate` (trough) and `peak_rate` over `duration`
    seconds, starting at the trough.  This is the canonical elastic-serving
    shape — a peak-provisioned static fleet idles through the trough while
    an autoscaled fleet tracks the curve (benchmarks/fig_autoscale.py)."""
    if peak_rate < base_rate:
        raise ValueError("peak_rate must be >= base_rate")
    period = duration if period is None else period
    rng = np.random.default_rng(seed)
    mid = (base_rate + peak_rate) / 2.0
    amp = (peak_rate - base_rate) / 2.0

    def rate(t: float) -> float:
        # trough at t=0, peak at t=period/2
        return mid - amp * np.cos(2.0 * np.pi * t / period)

    arrivals = _thinned_arrivals(rng, rate, peak_rate, duration)
    return _fill_lengths(rng, arrivals, mean_input, mean_output, sigma,
                         max_input, max_output, vocab)


def flash_crowd_requests(
    duration: float,
    *,
    base_rate: float,
    spike_rate: float,
    spike_start: float,
    spike_len: float,
    mean_input: float = 64.0,
    mean_output: float = 32.0,
    sigma: float = 0.6,
    max_input: int = 2048,
    max_output: int = 512,
    seed: int = 0,
    vocab: int = 32000,
) -> List[Tuple[float, List[int], int]]:
    """Flash crowd: steady `base_rate` with a step to `spike_rate` on
    [spike_start, spike_start + spike_len) — the worst case for reactive
    scaling (no leading edge to anticipate) and the soak tests' stressor."""
    if spike_rate < base_rate:
        raise ValueError("spike_rate must be >= base_rate")
    rng = np.random.default_rng(seed)

    def rate(t: float) -> float:
        in_spike = spike_start <= t < spike_start + spike_len
        return spike_rate if in_spike else base_rate

    arrivals = _thinned_arrivals(rng, rate, spike_rate, duration)
    return _fill_lengths(rng, arrivals, mean_input, mean_output, sigma,
                         max_input, max_output, vocab)


def _fill_lengths(rng: np.random.Generator, arrivals: List[float],
                  mean_input: float, mean_output: float, sigma: float,
                  max_input: int, max_output: int,
                  vocab: int) -> List[Tuple[float, List[int], int]]:
    n = len(arrivals)
    if n == 0:
        return []
    in_lens = np.clip(_lognormal(rng, mean_input, sigma, n),
                      4, max_input).astype(int)
    out_lens = np.clip(_lognormal(rng, mean_output, sigma, n),
                       1, max_output).astype(int)
    return [(float(t), rng.integers(0, vocab, int(li)).tolist(), int(lo))
            for t, li, lo in zip(arrivals, in_lens, out_lens)]


def multi_turn_requests(
    num_conversations: int,
    request_rate: float,
    *,
    mean_turns: float = 4.0,
    max_turns: int = 12,
    mean_user: float = 48.0,
    mean_output: float = 64.0,
    sigma: float = 0.6,
    max_user: int = 1024,
    max_output: int = 512,
    think_time: float = 2.0,
    seed: int = 0,
    vocab: int = 32000,
) -> List[Tuple[float, List[int], int]]:
    """Multi-turn chat: each conversation is a sequence of turns where turn
    k's prompt is the *entire* history so far (all previous user turns and
    synthetic assistant replies) plus a fresh user message — so all but the
    final user message is prefill a cache-holding replica skips.

    Conversations open with Poisson arrivals at `request_rate`; follow-up
    turns arrive an exponential `think_time` after the previous turn's
    deadline (history length / reading speed is not modeled — think time
    dominates).  The synthetic assistant reply appended to the history is
    `output_len` tokens drawn from the same rng, standing in for whatever
    the engine actually sampled (sim and engine runs stay workload-
    identical: arrivals depend only on the seed, not on served outputs)."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / max(request_rate, 1e-9), num_conversations)
    starts = np.cumsum(gaps)
    out = []
    for c in range(num_conversations):
        turns = int(np.clip(rng.geometric(1.0 / max(mean_turns, 1.0)),
                            1, max_turns))
        history: List[int] = []
        t = float(starts[c])
        for _ in range(turns):
            user_len = int(np.clip(_lognormal(rng, mean_user, sigma, 1)[0],
                                   1, max_user))
            out_len = int(np.clip(_lognormal(rng, mean_output, sigma, 1)[0],
                                  1, max_output))
            user = rng.integers(0, vocab, user_len).tolist()
            prompt = history + user
            out.append((t, prompt, out_len))
            # synthetic assistant reply extends the next turn's history
            reply = rng.integers(0, vocab, out_len).tolist()
            history = prompt + reply
            t += float(rng.exponential(think_time))
    out.sort(key=lambda a: a[0])
    return out
