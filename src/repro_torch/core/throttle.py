"""Token Throttling — the paper's core contribution (gLLM §3.1–§3.2).

Pure, side-effect-free policy functions mapping *global system state* to
per-micro-batch token budgets.  All equations are from the paper:

  eq. (1)  WT:  #P = min(max(#WP / #T, #MinP), #MaxP)
  eq. (2)  UT:  #P = max(#MaxP * KV_free, #MinP)
  eq. (3)  combined (+ threshold):
           #P = max(min(#WP / #T, #MaxP * (KV_free - KV_th)/(1 - KV_th)), #MinP)
           with prefill suspended entirely when KV_free <= KV_th (§3.1.3)
  eq. (4)  decode: #D = #RD / #PP_depth

The functions return *token* budgets; the scheduler (`scheduler.py`) turns
budgets into concrete request selections and KV allocations.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass


class PrefillPolicy(enum.Enum):
    """Which prefill-throttling terms are active (for the paper's ablations)."""

    GLLM = "gllm"          # eq. (3): WT + UT + threshold (the full technique)
    NO_WT = "no_wt"        # ablation "gLLM w/o WT": eq. (2) + threshold
    NO_UT = "no_ut"        # ablation "gLLM w/o UT": eq. (1) only
    SARATHI = "sarathi"    # "gLLM w/ CK": fixed-budget chunked-prefill policy


@dataclass(frozen=True)
class ThrottleConfig:
    """Hyperparameters; defaults are the paper's evaluation settings (§4.1)."""

    num_iters_T: int = 8            # #T    — horizon to drain the waiting pool
    max_prefill_tokens: int = 2048  # #MaxP — also Sarathi's token budget
    min_prefill_tokens: int = 32    # #MinP
    kv_threshold: float = 0.05      # KV_thresh — idle-rate floor (§3.1.3)
    pipeline_depth: int = 4         # #PP_depth — micro-batches in flight
    policy: PrefillPolicy = PrefillPolicy.GLLM

    def __post_init__(self) -> None:
        if not (0.0 <= self.kv_threshold < 1.0):
            raise ValueError(f"kv_threshold must be in [0,1): {self.kv_threshold}")
        if self.num_iters_T < 1 or self.pipeline_depth < 1:
            raise ValueError("num_iters_T and pipeline_depth must be >= 1")
        if self.min_prefill_tokens > self.max_prefill_tokens:
            raise ValueError("min_prefill_tokens > max_prefill_tokens")


# --------------------------------------------------------------------------
# Prefill throttling
# --------------------------------------------------------------------------

def prefill_budget_wt(waiting_tokens: int, cfg: ThrottleConfig) -> int:
    """eq. (1): throttle by tokens awaiting prefill (WT)."""
    if waiting_tokens <= 0:
        return 0
    spread = math.ceil(waiting_tokens / cfg.num_iters_T)
    return min(max(spread, cfg.min_prefill_tokens), cfg.max_prefill_tokens)


def prefill_budget_ut(kv_free: float, cfg: ThrottleConfig) -> int:
    """eq. (2): throttle by KV-cache idle rate (UT)."""
    kv_free = min(max(kv_free, 0.0), 1.0)
    return max(int(cfg.max_prefill_tokens * kv_free), cfg.min_prefill_tokens)


def _ut_scale(kv_free: float, cfg: ThrottleConfig) -> float:
    """UT budget with the threshold safeguard of §3.1.3 folded in (eq. 3)."""
    if kv_free <= cfg.kv_threshold:
        return 0.0
    return cfg.max_prefill_tokens * (kv_free - cfg.kv_threshold) / (1.0 - cfg.kv_threshold)


def prefill_budget(waiting_tokens: int, kv_free: float, cfg: ThrottleConfig) -> int:
    """eq. (3): combined WT + UT + threshold prefill token budget.

    Hard guards (both from §3.1): zero pending tokens => nothing to schedule;
    KV idle rate at/below the threshold => prefill suspended.
    """
    if waiting_tokens <= 0:
        return 0
    kv_free = min(max(kv_free, 0.0), 1.0)

    if cfg.policy is PrefillPolicy.NO_UT:
        budget = float(prefill_budget_wt(waiting_tokens, cfg))
    elif cfg.policy is PrefillPolicy.NO_WT:
        if kv_free <= cfg.kv_threshold:
            return 0
        budget = max(_ut_scale(kv_free, cfg), cfg.min_prefill_tokens)
    else:  # GLLM (eq. 3) — SARATHI never calls this function
        if kv_free <= cfg.kv_threshold:
            return 0
        wt = math.ceil(waiting_tokens / cfg.num_iters_T)
        budget = max(min(float(wt), _ut_scale(kv_free, cfg)), cfg.min_prefill_tokens)

    # Never schedule more than exists, never exceed #MaxP.
    return int(min(budget, cfg.max_prefill_tokens, waiting_tokens))


# --------------------------------------------------------------------------
# Decode throttling
# --------------------------------------------------------------------------

def decode_budget(running_decode: int, cfg: ThrottleConfig) -> int:
    """eq. (4): spread decode tokens evenly over the in-flight micro-batches.

    One decode request contributes exactly one token per iteration, so the
    budget is in requests == tokens.  Ceil so the pool drains without a
    trailing remainder micro-batch.
    """
    if running_decode <= 0:
        return 0
    return math.ceil(running_decode / cfg.pipeline_depth)
