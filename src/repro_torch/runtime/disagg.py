"""Disaggregated prefill/decode serving: replica roles + handoff policy
(DESIGN.md §15).

A copy of ``repro.runtime.disagg``: the port keeps its own so that it imports
nothing of the JAX package.

gLLM's Token Throttling balances prefill and decode *within* hybrid
batches; TD-Pipe argues the two phases should be *temporally separated* —
prefill and decode interfere inside a tick (a large prefill chunk inflates
every co-scheduled decode's token-to-token latency), so dedicating whole
replicas to each phase buys clean TBT at the cost of moving every
request's KV once.  This module holds the declarative half of that cluster
shape:

* **roles** — each replica is `"prefill"`, `"decode"`, or `"mixed"`.
  `ReplicaRouter` admits new requests only to prefill-capable replicas
  (prefill or mixed) and hands work off to decode-capable ones.
* **`HandoffPolicy`** — when and how aggressively a prefill-role replica
  ships a request that has completed its prefill to a decode replica.
  The handoff rides the PR 3 live-migration wire format (`export_kv` /
  `import_kv` + backend page gather/scatter) and is recorded as
  `handoff` records (trace schema 1.5) so per-replica traces replay
  byte-identically through the move.

The router owns the pass itself (it needs balance scores and the
in-transit machinery); this module stays import-light — policy data,
role vocabulary, candidate selection — so the spec layer can depend on
it without pulling in the control plane.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"
ROLE_MIXED = "mixed"
ROLES = (ROLE_PREFILL, ROLE_DECODE, ROLE_MIXED)


def prefill_capable(role: str) -> bool:
    """May admit new requests (runs prefill chunks)."""
    return role != ROLE_DECODE


def decode_capable(role: str) -> bool:
    """May hold decode residents (receives handoffs)."""
    return role != ROLE_PREFILL


def validate_roles(roles: Sequence[str], num_replicas: int
                   ) -> Tuple[str, ...]:
    """Normalize + validate a per-replica role assignment: one role per
    replica, values from `ROLES`, and the cluster must be able to both
    admit (>=1 prefill-capable) and decode (>=1 decode-capable)."""
    out = tuple(roles)
    if len(out) != num_replicas:
        raise ValueError(
            f"one role per replica: got {len(out)} roles for "
            f"{num_replicas} replicas")
    for r in out:
        if r not in ROLES:
            raise ValueError(f"unknown replica role {r!r}; "
                             f"expected one of {ROLES}")
    if not any(prefill_capable(r) for r in out):
        raise ValueError("cluster has no prefill-capable replica; "
                         "new requests could never be admitted")
    if not any(decode_capable(r) for r in out):
        raise ValueError("cluster has no decode-capable replica; "
                         "prefilled requests could never decode")
    return out


def retirable(roles: Sequence[str], i: int) -> bool:
    """May replica `i` be drained and retired without breaking the fleet's
    role cover?  The surviving set must still satisfy `validate_roles`'
    liveness conditions: at least one prefill-capable replica (or new
    requests could never be admitted) and at least one decode-capable one
    (or prefilled requests could never decode).  The autoscaler checks
    this before choosing a drain victim — the last prefill- or
    decode-capable replica of a disaggregated fleet is never retired."""
    rest = [r for j, r in enumerate(roles) if j != i]
    return (any(prefill_capable(r) for r in rest)
            and any(decode_capable(r) for r in rest))


@dataclass(frozen=True)
class HandoffPolicy:
    """When a prefill-role replica ships a freshly-prefilled request to a
    decode replica.  Mirrors `RebalancePolicy`'s shape: a polling
    `interval`, a per-pass cap, and hysteresis so the disagg plane and
    the rebalance plane don't fight over the same KV.

    A request becomes handoff-eligible the moment its prefill completes
    (the final chunk samples the first token, so "zero decode steps
    executed" is `num_output_tokens <= 1`); it *stays* eligible while it
    has sampled at most `max_decode_tokens` outputs — a deferred handoff
    (no destination headroom this pass) retries on later passes until the
    request is established decode work, at which point moving it is the
    rebalance plane's call, not a handoff.  Destination choice reuses
    `balance_score` over decode-capable replicas with the same
    projected-KV headroom guard as live migration; each request moves at
    most `max_request_handoffs` times.
    """

    interval: float = 0.05
    handoff_batch: int = 8
    max_decode_tokens: int = 4
    max_request_handoffs: int = 1


@dataclass
class DisaggStats:
    """Control-plane counters for the handoff plane (surfaced through
    `LLMServer.stats()` / `GET /v1/stats`)."""

    passes: int = 0
    handoffs: int = 0
    handoff_tokens: int = 0     # KV tokens shipped prefill -> decode
    deferred: int = 0           # eligible but no destination had headroom
    fallbacks: int = 0          # delivery degraded to recompute admission


def handoff_candidates(replica, policy: HandoffPolicy,
                       handoffs_of: Dict[str, int]) -> List:
    """First-decode requests on a prefill-role replica, in handoff
    priority order: least decode progress first (the cheapest point to
    move — minimal KV beyond the prompt, no decode momentum lost), ties
    broken toward the earliest arrival (TTFT debt)."""
    out = [r for r in replica.scheduler.running_decode
           if r.num_output_tokens <= policy.max_decode_tokens
           and handoffs_of.get(r.request_id, 0)
           < policy.max_request_handoffs]
    out.sort(key=lambda r: (r.num_output_tokens,
                            r.metrics.arrival_time))
    return out
