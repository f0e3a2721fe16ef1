"""Request lifecycle primitives for the gLLM serving engine.

A request moves through:  WAITING -> PREFILLING (possibly chunked over several
micro-batches) -> DECODING -> FINISHED.  It may be PREEMPTED while decoding
(KV pages reclaimed); preempted requests re-enter the waiting queue and are
recovered by recompute (prompt + generated tokens are re-prefilled), matching
vLLM/gLLM recompute semantics.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Sequence


class RequestState(enum.Enum):
    WAITING = "waiting"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    PREEMPTED = "preempted"
    FINISHED_STOPPED = "finished_stopped"      # hit eos
    FINISHED_LENGTH = "finished_length"        # hit max_new_tokens
    FINISHED_ABORTED = "finished_aborted"      # user / fault abort

    @property
    def is_finished(self) -> bool:
        return self in (
            RequestState.FINISHED_STOPPED,
            RequestState.FINISHED_LENGTH,
            RequestState.FINISHED_ABORTED,
        )


# Public finish-reason vocabulary of the serving API (repro_torch.serving): every
# finished request maps to exactly one of these strings.
FINISH_REASONS = {
    RequestState.FINISHED_STOPPED: "stop",
    RequestState.FINISHED_LENGTH: "length",
    RequestState.FINISHED_ABORTED: "abort",
}


# SLO-class vocabulary.  A request's class picks its point on the
# throughput-latency tradeoff (Sarathi-Serve, arXiv:2403.02310): interactive
# requests are admitted ahead of batch ones when the Token Throttling prefill
# budget (eq. 3) is contended, and batch requests are preferred as preemption
# victims when the KV pool saturates.  Within a class, higher `priority`
# wins; within a priority, FCFS order is preserved.
SLO_INTERACTIVE = "interactive"
SLO_BATCH = "batch"
SLO_CLASSES = (SLO_INTERACTIVE, SLO_BATCH)
# admission rank: lower admits first / is victimized last
SLO_RANK = {cls: i for i, cls in enumerate(SLO_CLASSES)}


@dataclass
class SamplingParams:
    max_new_tokens: int = 128
    temperature: float = 0.0          # 0.0 => greedy
    top_k: int = 0                    # 0 => disabled
    top_p: float = 1.0
    stop_token_ids: Sequence[int] = ()
    # Scheduling class (not sampling, but per-request like everything here —
    # the one bag of knobs a client attaches to a request, vLLM-style).
    priority: int = 0                 # higher admits first within a class
    slo_class: str = SLO_INTERACTIVE  # "interactive" | "batch"

    def __post_init__(self) -> None:
        if self.slo_class not in SLO_CLASSES:
            raise ValueError(
                f"unknown slo_class {self.slo_class!r}; expected one of "
                f"{SLO_CLASSES}")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


@dataclass
class RequestMetrics:
    arrival_time: float = 0.0
    first_scheduled_time: Optional[float] = None
    first_token_time: Optional[float] = None   # TTFT = first_token - arrival
    finish_time: Optional[float] = None
    num_preemptions: int = 0

    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    def e2el(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival_time

    def tpot(self, num_output_tokens: int) -> Optional[float]:
        """Mean time-per-output-token after the first token."""
        if self.finish_time is None or self.first_token_time is None:
            return None
        if num_output_tokens <= 1:
            return 0.0
        return (self.finish_time - self.first_token_time) / (num_output_tokens - 1)


@dataclass
class Request:
    request_id: str
    prompt_token_ids: List[int]
    sampling: SamplingParams = field(default_factory=SamplingParams)
    state: RequestState = RequestState.WAITING
    output_token_ids: List[int] = field(default_factory=list)
    # Chunked-prefill progress over the *effective* prompt (see below).  After a
    # preemption the generated tokens are folded into the effective prompt and
    # recomputed, so num_prefilled always counts tokens whose KV is resident.
    num_prefilled: int = 0
    metrics: RequestMetrics = field(default_factory=RequestMetrics)

    # ----------------------------------------------------------------- class
    @property
    def slo_class(self) -> str:
        return self.sampling.slo_class

    @property
    def priority(self) -> int:
        return self.sampling.priority

    @property
    def slo_rank(self) -> int:
        """Admission rank (lower admits first); unknown classes sort last."""
        return SLO_RANK.get(self.sampling.slo_class, len(SLO_CLASSES))

    # ------------------------------------------------------------------ sizes
    @property
    def num_prompt_tokens(self) -> int:
        return len(self.prompt_token_ids)

    @property
    def num_output_tokens(self) -> int:
        return len(self.output_token_ids)

    @property
    def effective_prompt(self) -> List[int]:
        """Tokens that must have resident KV before the next decode step.

        After preemption-by-recompute the already-generated tokens are treated
        as prompt (they are re-prefilled).
        """
        return self.prompt_token_ids + self.output_token_ids

    @property
    def num_effective_prompt_tokens(self) -> int:
        return len(self.prompt_token_ids) + len(self.output_token_ids)

    @property
    def remaining_prefill_tokens(self) -> int:
        return max(0, self.num_effective_prompt_tokens - self.num_prefilled)

    @property
    def prefill_done(self) -> bool:
        return self.remaining_prefill_tokens == 0

    @property
    def seq_len(self) -> int:
        """Tokens with resident KV (context length for attention)."""
        return self.num_prefilled

    # ------------------------------------------------------------- transitions
    def record_new_token(self, token_id: int, now: float) -> None:
        """Append a sampled token.  KV accounting (num_prefilled) is advanced
        by the scheduler from the ScheduledSeq that produced the token, not
        here — decode steps write the *consumed* token's KV, while a final
        prefill chunk has already written KV for the whole chunk."""
        self.output_token_ids.append(token_id)
        if self.metrics.first_token_time is None:
            self.metrics.first_token_time = now
        if token_id in tuple(self.sampling.stop_token_ids):
            self.state = RequestState.FINISHED_STOPPED
            self.metrics.finish_time = now
        elif self.num_output_tokens >= self.sampling.max_new_tokens:
            self.state = RequestState.FINISHED_LENGTH
            self.metrics.finish_time = now

    def preempt(self) -> None:
        """Reset for recompute: generated tokens fold into the prompt."""
        self.state = RequestState.PREEMPTED
        self.num_prefilled = 0
        self.metrics.num_preemptions += 1

    @property
    def is_finished(self) -> bool:
        return self.state.is_finished

    @property
    def finish_reason(self) -> Optional[str]:
        """"stop" / "length" / "abort" once finished, else None."""
        return FINISH_REASONS.get(self.state)
