"""gLLM core: Token Throttling scheduling + paged KV management."""

from repro_torch.core.kv_manager import (
    KVExport,
    PagedKVManager,
    ReplicaKVManager,
)
from repro_torch.core.request import (
    SLO_BATCH,
    SLO_CLASSES,
    SLO_INTERACTIVE,
    Request,
    RequestMetrics,
    RequestState,
    SamplingParams,
)
from repro_torch.core.scheduler import (
    PipelineScheduler,
    ScheduledBatch,
    ScheduledSeq,
    SchedulerStats,
)
from repro_torch.core.throttle import (
    PrefillPolicy,
    ThrottleConfig,
    decode_budget,
    prefill_budget,
    prefill_budget_ut,
    prefill_budget_wt,
)

__all__ = [
    "KVExport",
    "PagedKVManager",
    "ReplicaKVManager",
    "Request",
    "RequestMetrics",
    "RequestState",
    "SamplingParams",
    "SLO_BATCH",
    "SLO_CLASSES",
    "SLO_INTERACTIVE",
    "PipelineScheduler",
    "ScheduledBatch",
    "ScheduledSeq",
    "SchedulerStats",
    "PrefillPolicy",
    "ThrottleConfig",
    "decode_budget",
    "prefill_budget",
    "prefill_budget_ut",
    "prefill_budget_wt",
]
