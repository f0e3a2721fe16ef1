"""Trace record/replay: deterministic tick traces as the third
`ExecutionBackend` (DESIGN.md §8).

A copy of ``repro.runtime.trace``: the port keeps its own so that it imports
nothing of the JAX package.  The schema, its version and `dumps_record`'s
serialisation are the JAX module's, so a trace recorded by either package
replays in the other byte for byte.

The runtime's policy/execution split (runtime/core.py) means one tick is
fully described by *what the scheduler decided* (the micro-batch) and *what
the backend reported* (sampled tokens, completion time, per-stage latency).
`TraceRecorder` wraps any `ExecutionBackend` — the live `TorchBackend` or the
analytic `SimBackend` — and logs one structured record per tick to a
versioned JSONL stream.  `TraceBackend` is the third backend: it replays a
recorded trace through the *unmodified* `TickLoop`/`PipelineScheduler`,
substituting recorded latencies for computed ones and (in strict mode)
asserting the scheduler reproduces the recorded batch decisions — any
divergence is reported with the exact tick index and field diff.

This is the calibration loop Sarathi-Serve (arXiv:2403.02310) and TD-Pipe
(arXiv:2506.10470) build their evaluations on: capture what a real run did,
then re-examine, re-test, and re-fit offline.  Every scheduler/throttle/
router claim in this repo becomes deterministically reproducible in CI
without an accelerator (tests/test_torch_trace.py replays the checked-in
golden traces).

Record kinds (one JSON object per line):

  header  schema/version + everything needed to rebuild the scheduler
          (throttle config, KV pool geometry, scheduler caps, ring depth)
  req     a request entering the scheduler (id, arrival, prompt, sampling —
          incl. priority + SLO class since schema 1.2: admission order
          depends on them)
  tick    one pipeline tick: entering micro-batch composition, the throttle
          budgets that shaped it, KV/queue signals, per-stage latency, and
          the exiting batch's sampled tokens + completion time
  reset   fault recovery: all in-flight work was lost (abort + restart)
  abort   user-initiated abort of one request (schema 1.1): applied in
          stream order, so replay reproduces the exact lifecycle —
          including aborts that finalize at the next batch retire
  migrate control-plane live migration (§9): op="out" drains a request off
          this replica; op="in" adopts one at its current position (full
          request state embedded, so each replica's trace replays alone)
  route   (router traces) one placement decision: scores + chosen replica

Compaction: long production runs repeat most tick fields (steady-state
decode ticks differ only in `now`/`exit`).  `compact_records` delta-encodes
ticks against the previous tick — a field absent from a compacted record is
unchanged, and a steady decode batch (same requests, every position advanced
by one, consecutive batch id) collapses to the marker `"batch": "+1"` — and
marks the header `"compact": true`; `Trace.from_records` expands
transparently, so compacted traces replay, fit, and gate CI exactly like
raw ones (the expansion is lossless to the byte).

CLI:

    python -m repro_torch.runtime.trace check   FILE...   # strict replay + identity
    python -m repro_torch.runtime.trace replay  FILE [--timing-only]
    python -m repro_torch.runtime.trace fit     FILE [--arch A] [--pp N]
    python -m repro_torch.runtime.trace compact FILE [-o OUT]
"""

from __future__ import annotations

import itertools
import json
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, IO, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import (
    PagedKVManager,
    PipelineScheduler,
    PrefillPolicy,
    ReplicaKVManager,
    Request,
    RequestState,
    SamplingParams,
    ThrottleConfig,
)
from repro_torch.runtime.core import ExecResult, ExecutionBackend, TickLoop

SCHEMA = "gllm-trace"
ROUTE_SCHEMA = "gllm-route"
SCHEMA_MAJOR = 1
SCHEMA_MINOR = 6    # 1.1: "abort" record kind; 1.2: req/migrate carry
                    # per-request priority + SLO class; 1.3: ticks may carry
                    # "host_s" (per-tick host overhead — engine measures it,
                    # sim models it, RuntimeModel.fit_from_trace calibrates
                    # against it); absent on backends that don't report it,
                    # so 1.2 traces remain byte-identical; 1.4: ticks carry
                    # "cached" (prefill tokens skipped via adopted cached
                    # prefixes this tick) iff the scheduler has prefix
                    # caching enabled — pre-1.4 traces (and all recordings
                    # with caching off) keep their exact bytes; 1.5:
                    # "handoff" record kind (disagg prefill->decode
                    # transfer, same op=out/in layout as "migrate") and
                    # compacted ticks may run-length encode "stage_times"
                    # and exit token lists — raw (non-compact) tick bytes
                    # are unchanged, so pre-1.5 layouts are preserved; 1.6:
                    # "scale_up" / "drain" / "retire" record kinds (elastic
                    # fleet lifecycle markers written by the autoscaler —
                    # no scheduler state change on replay, re-recorded
                    # verbatim so elastic traces stay byte-identical);
                    # pre-1.6 traces carry none and keep their exact bytes.
                    # An engine over dp > 1 data replicas (the port's
                    # `ReplicaKVManager`) also writes the header's
                    # kv.replicas / kv.pool_pages and each tick's
                    # "replicas" (every row's replica, in batch order); at
                    # one pool neither appears, so such a trace is 1.6 byte
                    # for byte and loads in the JAX package


class TraceSchemaError(ValueError):
    """The stream is not a trace this code can interpret."""


class TraceDivergence(AssertionError):
    """Strict replay produced a different decision than the recording.

    `tick` is the 0-based tick index; `diffs` is [(field, recorded, actual)].
    """

    def __init__(self, tick: int, diffs: List[Tuple[str, Any, Any]]) -> None:
        self.tick = tick
        self.diffs = diffs
        lines = [f"replay diverged from trace at tick {tick}:"]
        for fieldname, want, got in diffs:
            lines.append(f"  {fieldname}: recorded={want!r} replayed={got!r}")
        super().__init__("\n".join(lines))


def _to_jsonable(obj: Any) -> Any:
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    raise TypeError(f"not JSON serializable: {type(obj)}")


def dumps_record(rec: Dict[str, Any]) -> str:
    """Canonical one-line serialization (insertion order, compact, shortest
    round-trip floats) — the unit of the bit-identity guarantee."""
    return json.dumps(rec, separators=(",", ":"), default=_to_jsonable)


Sink = Union[None, str, IO[str]]


class TraceWriter:
    """Appends records to an optional line-flushed sink, keeping them in
    memory (so a finished recording is available as a `Trace` without a
    read-back)."""

    def __init__(self, sink: Sink = None) -> None:
        self.records: List[Dict[str, Any]] = []
        self._owns = isinstance(sink, str)
        self._fh: Optional[IO[str]] = open(sink, "w") if self._owns else sink
        self._lock = threading.Lock()   # whole lines even under threaded use

    def write(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            self.records.append(rec)
            if self._fh is not None:
                self._fh.write(dumps_record(rec) + "\n")
                self._fh.flush()

    def close(self) -> None:
        if self._fh is not None and self._owns:
            self._fh.close()
        self._fh = None

    def __del__(self) -> None:  # pragma: no cover - GC ordering
        try:
            self.close()
        except Exception:
            pass


@dataclass
class Trace:
    """A parsed trace: the header plus all subsequent records, in order."""

    header: Dict[str, Any]
    records: List[Dict[str, Any]]

    # ------------------------------------------------------------------ views
    @property
    def ticks(self) -> List[Dict[str, Any]]:
        return [r for r in self.records if r["kind"] == "tick"]

    @property
    def requests(self) -> List[Dict[str, Any]]:
        return [r for r in self.records if r["kind"] == "req"]

    @property
    def depth(self) -> int:
        return int(self.header["depth"])

    # ----------------------------------------------------------------- (de)io
    @staticmethod
    def from_records(records: Sequence[Dict[str, Any]],
                     expect: str = SCHEMA) -> "Trace":
        if not records:
            raise TraceSchemaError("empty trace")
        header = records[0]
        if header.get("kind") != "header" or header.get("schema") != expect:
            raise TraceSchemaError(
                f"first record is not a {expect!r} header: {header!r}")
        major = int(header.get("version", [0, 0])[0])
        if major != SCHEMA_MAJOR:
            raise TraceSchemaError(
                f"unsupported {expect} schema major {major} "
                f"(this reader speaks {SCHEMA_MAJOR}.x)")
        if header.get("compact"):
            expanded = expand_records(records)
            return Trace(expanded[0], expanded[1:])
        return Trace(header, list(records[1:]))

    @staticmethod
    def loads(text: str, expect: str = SCHEMA) -> "Trace":
        records = [json.loads(line) for line in text.splitlines() if line]
        return Trace.from_records(records, expect)

    @staticmethod
    def load(path: str, expect: str = SCHEMA) -> "Trace":
        with open(path) as fh:
            return Trace.loads(fh.read(), expect)

    def dumps(self) -> str:
        lines = [dumps_record(self.header)]
        lines.extend(dumps_record(r) for r in self.records)
        return "\n".join(lines) + "\n"

    def dump(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write(self.dumps())


# ---------------------------------------------------------------------------
# Compaction: delta-encoded tick records
# ---------------------------------------------------------------------------

# Canonical tick field order, exactly as `TraceRecorder.execute` writes it —
# compaction and expansion both key off this so the round trip is
# byte-identical under `dumps_record`.  Optional fields ("cached", schema
# 1.4; "host_s", schema 1.3) are present uniformly or omitted trace-wide
# (never mixed): "host_s" appears iff the backend reports host overhead,
# "cached" iff the scheduler has prefix caching enabled — so earlier-schema
# streams keep their exact bytes.
TICK_FIELDS = ("now", "batch", "replicas", "prefill_budget",
               "decode_budget", "kv_free", "wp", "rd", "preempts",
               "stage_times", "cached", "host_s", "exit")
_OPTIONAL_TICK_FIELDS = ("replicas", "cached", "host_s")
_CANONICAL_TICK_KEYS = ["kind", "tick"] + list(TICK_FIELDS)
# Every omit-in-place subset of the optional fields is a valid canonical
# layout (a trace may carry any combination, each uniformly).
_VALID_TICK_KEY_LISTS = [
    [k for k in _CANONICAL_TICK_KEYS if k not in omitted]
    for r in range(len(_OPTIONAL_TICK_FIELDS) + 1)
    for omitted in itertools.combinations(_OPTIONAL_TICK_FIELDS, r)]


STEADY_DECODE = "+1"    # batch marker: the cohort's previous batch, +1 step
_ABSENT = object()      # sentinel: field not present on the previous tick


def _is_steady_decode(cohort_batch: Optional[Dict[str, Any]],
                      batch: Optional[Dict[str, Any]], depth: int) -> bool:
    """True when `batch` is the *cohort's* previous micro-batch advanced one
    decode step.  The pipeline's exclusion rule (one resident micro-batch
    per request) means a decode cohort recurs every `depth` ticks, not every
    tick — so the reference is the batch from `depth` ticks earlier: no
    prefill on either side, batch id advanced by exactly `depth` (one id per
    tick), and the same requests each one position further.  This is the
    steady state a saturated decode run repeats for thousands of ticks."""
    if cohort_batch is None or batch is None:
        return False
    if cohort_batch["prefill"] or batch["prefill"]:
        return False
    if batch["id"] != cohort_batch["id"] + depth:
        return False
    return batch["decode"] == [[rid, start + 1]
                               for rid, start in cohort_batch["decode"]]


def _steady_decode_batch(cohort_batch: Dict[str, Any],
                         depth: int) -> Dict[str, Any]:
    """Reconstruct a `STEADY_DECODE` batch from the cohort's previous
    expanded one, in the recorder's canonical key order (byte-identity
    depends on it)."""
    return {"id": cohort_batch["id"] + depth,
            "prefill": [],
            "decode": [[rid, start + 1] for rid, start in
                       cohort_batch["decode"]]}


def _rle(lst: List[Any]) -> List[List[Any]]:
    runs: List[List[Any]] = []
    for v in lst:
        if runs and runs[-1][0] == v:
            runs[-1][1] += 1
        else:
            runs.append([v, 1])
    return runs


def _rle_expand(runs: Sequence[Sequence[Any]]) -> List[Any]:
    out: List[Any] = []
    for v, n in runs:
        out.extend([v] * int(n))
    return out


def _maybe_rle(lst: Any) -> Any:
    """Run-length encode a list as `{"r": [[value, count], ...]}` iff the
    encoding is strictly shorter under the canonical serialization (schema
    1.5).  Deterministic, so compaction of an expanded stream reproduces
    the same bytes; a raw list is never a dict, so expansion can always
    tell the two forms apart."""
    if not isinstance(lst, list) or len(lst) < 2:
        return lst
    enc = {"r": _rle(lst)}
    if len(dumps_record(enc)) < len(dumps_record(lst)):
        return enc
    return lst


def _expand_rle_fields(full: Dict[str, Any]) -> None:
    """Undo `_maybe_rle` on a tick's stage_times / exit token list."""
    st = full.get("stage_times")
    if isinstance(st, dict):
        full["stage_times"] = _rle_expand(st["r"])
    ex = full.get("exit")
    if isinstance(ex, dict) and isinstance(ex.get("tokens"), dict):
        full["exit"] = {**ex, "tokens": _rle_expand(ex["tokens"]["r"])}


def compact_records(records: Sequence[Dict[str, Any]]
                    ) -> List[Dict[str, Any]]:
    """Delta-encode a raw trace: each tick keeps only the fields that differ
    from the previous tick, and a steady decode batch (same requests, start
    positions advanced by one, consecutive id) collapses to the
    `STEADY_DECODE` marker — decode-heavy runs shrink a further ~2x beyond
    the scalar-field deltas.  The header gains `"compact": true`; non-tick
    records pass through verbatim.  Raises `TraceSchemaError` on ticks not
    in the recorder's canonical field order — those could not be re-expanded
    byte-identically."""
    header = records[0]
    if header.get("kind") != "header":
        raise TraceSchemaError("first record must be the header")
    if header.get("compact"):
        return list(records)
    depth = int(header.get("depth", 1))
    out: List[Dict[str, Any]] = [{**header, "compact": True}]
    prev: Optional[Dict[str, Any]] = None
    ring: Deque[Dict[str, Any]] = deque(maxlen=depth)   # last `depth` ticks
    counter = 0
    for rec in records[1:]:
        if rec.get("kind") != "tick":
            out.append(rec)
            continue
        if list(rec) not in _VALID_TICK_KEY_LISTS:
            raise TraceSchemaError(
                f"tick {rec.get('tick')} is not in canonical field order; "
                "cannot delta-encode losslessly")
        small: Dict[str, Any] = {"kind": "tick"}
        if rec["tick"] != counter:
            small["tick"] = rec["tick"]
        counter = rec["tick"] + 1
        for f in TICK_FIELDS:
            if f not in rec:                 # optional field, omitted trace-wide
                continue
            if prev is None or prev.get(f, _ABSENT) != rec[f]:
                small[f] = rec[f]
        if len(ring) == depth and _is_steady_decode(ring[0]["batch"],
                                                    rec["batch"], depth):
            small["batch"] = STEADY_DECODE
        # schema 1.5: run-length encode the per-stage latency vector and
        # the exiting micro-batch's token list when that is a net win —
        # long decode runs emit [t]*depth latencies and (in sim) constant
        # token ids every tick, which the field-delta alone cannot touch
        # because "exit" always differs tick-to-tick
        if isinstance(small.get("stage_times"), list):
            small["stage_times"] = _maybe_rle(small["stage_times"])
        ex = small.get("exit")
        if isinstance(ex, dict) and isinstance(ex.get("tokens"), list):
            toks = _maybe_rle(ex["tokens"])
            if toks is not ex["tokens"]:
                small["exit"] = {**ex, "tokens": toks}
        prev = rec
        ring.append(rec)
        out.append(small)
    return out


def expand_records(records: Sequence[Dict[str, Any]]
                   ) -> List[Dict[str, Any]]:
    """Inverse of `compact_records`: reconstruct every tick in full, in
    canonical field order, inheriting absent fields from the previous
    tick."""
    header = {k: v for k, v in records[0].items() if k != "compact"}
    out: List[Dict[str, Any]] = [header]
    depth = int(header.get("depth", 1))
    prev: Optional[Dict[str, Any]] = None
    ring: Deque[Dict[str, Any]] = deque(maxlen=depth)   # last `depth` ticks
    counter = 0
    for rec in records[1:]:
        if rec.get("kind") != "tick":
            out.append(rec)
            continue
        full: Dict[str, Any] = {"kind": "tick",
                                "tick": rec.get("tick", counter)}
        for f in TICK_FIELDS:
            if f == "batch" and rec.get(f) == STEADY_DECODE:
                if len(ring) < depth or ring[0]["batch"] is None:
                    raise TraceSchemaError(
                        f"compacted tick {full['tick']} marks a steady "
                        "decode batch but its cohort's previous batch is "
                        "undefined")
                full[f] = _steady_decode_batch(ring[0]["batch"], depth)
            elif f in rec:
                full[f] = rec[f]
            elif prev is not None and f in prev:
                full[f] = prev[f]
            elif f in _OPTIONAL_TICK_FIELDS:
                continue                     # omitted trace-wide (pre-1.3)
            else:
                raise TraceSchemaError(
                    f"compacted tick {full['tick']} omits {f!r} but no "
                    "previous tick defines it")
        _expand_rle_fields(full)             # schema 1.5 run-length forms
        counter = full["tick"] + 1
        out.append(full)
        prev = full
        ring.append(full)
    return out


# ---------------------------------------------------------------------------
# Recording
# ---------------------------------------------------------------------------

def _batch_summary(batch) -> Optional[Dict[str, Any]]:
    """JSON form of a micro-batch's composition — the scheduler *decision*
    strict replay asserts on.  Prefill entries carry the produces-token flag
    so replayed traces can track decode-population promotions."""
    if batch is None:
        return None
    return {
        "id": batch.batch_id,
        "prefill": [[s.request.request_id, s.start_pos, s.num_tokens,
                     int(s.produces_token)] for s in batch.prefill],
        "decode": [[s.request.request_id, s.start_pos]
                   for s in batch.decode],
    }


def _pools(kv) -> int:
    """Data replicas of a KV manager: a `ReplicaKVManager`'s pools, 1 for
    one pool."""
    return kv.replicas if isinstance(kv, ReplicaKVManager) else 1


def _row_replicas(kv, batch) -> Optional[List[List[int]]]:
    """Each row's data replica, prefill rows then decode rows (a tick
    record's ``replicas``)."""
    if batch is None:
        return None
    return [[kv.replica_of(s.request.request_id) for s in rows]
            for rows in (batch.prefill, batch.decode)]


def scheduler_header(scheduler: PipelineScheduler, depth: int
                     ) -> Dict[str, Any]:
    """The trace's header: the scheduler's configuration.  Over data
    replicas its ``kv`` also holds their count and each pool's pages
    (``num_pages`` stays their total, the UT signal's denominator)."""
    cfg = scheduler.cfg
    kv = scheduler.kv
    kvh = {"num_pages": kv.num_pages, "page_size": kv.page_size,
           "prefix_caching": kv.enable_prefix_caching}
    if _pools(kv) > 1:
        kvh.update(replicas=kv.replicas,
                   pool_pages=[p.num_pages for p in kv.pools])
    return {
        "kind": "header",
        "schema": SCHEMA,
        "version": [SCHEMA_MAJOR, SCHEMA_MINOR],
        "depth": depth,
        "throttle": {
            "num_iters_T": cfg.num_iters_T,
            "max_prefill_tokens": cfg.max_prefill_tokens,
            "min_prefill_tokens": cfg.min_prefill_tokens,
            "kv_threshold": cfg.kv_threshold,
            "pipeline_depth": cfg.pipeline_depth,
            "policy": cfg.policy.value,
        },
        "kv": kvh,
        "scheduler": {
            "max_model_len": scheduler.max_model_len,
            "max_batch_seqs": scheduler.max_batch_seqs,
            "max_prefill_seqs": scheduler.max_prefill_seqs,
            "max_chunk_tokens": scheduler.max_chunk_tokens,
            "max_decode_seqs": scheduler.max_decode_seqs,
        },
    }


def scheduler_from_header(header: Dict[str, Any]) -> PipelineScheduler:
    """Rebuild the exact scheduler configuration a trace was recorded with."""
    th = header["throttle"]
    cfg = ThrottleConfig(
        num_iters_T=th["num_iters_T"],
        max_prefill_tokens=th["max_prefill_tokens"],
        min_prefill_tokens=th["min_prefill_tokens"],
        kv_threshold=th["kv_threshold"],
        pipeline_depth=th["pipeline_depth"],
        policy=PrefillPolicy(th["policy"]),
    )
    kvh = header["kv"]
    if kvh.get("replicas", 1) > 1:
        pages = set(kvh["pool_pages"])
        if len(pages) != 1 or len(kvh["pool_pages"]) != kvh["replicas"]:
            raise TraceSchemaError(f"data replicas of unequal pools: "
                                   f"{kvh['pool_pages']}")
        kv = ReplicaKVManager(kvh["replicas"], pages.pop(),
                              kvh["page_size"],
                              enable_prefix_caching=kvh["prefix_caching"])
    else:
        kv = PagedKVManager(kvh["num_pages"], kvh["page_size"],
                            enable_prefix_caching=kvh["prefix_caching"])
    sh = header["scheduler"]
    return PipelineScheduler(
        cfg, kv,
        max_model_len=sh["max_model_len"],
        max_batch_seqs=sh["max_batch_seqs"],
        max_prefill_seqs=sh["max_prefill_seqs"],
        max_chunk_tokens=sh["max_chunk_tokens"],
        max_decode_seqs=sh["max_decode_seqs"],
    )


class TraceRecorder(ExecutionBackend):
    """Wraps any `ExecutionBackend`, logging one record per tick.

    Transparent to the `TickLoop`: every protocol call is forwarded to the
    wrapped backend; the recording is a pure observation of the scheduler
    state at execute time plus the backend's `ExecResult`.  Integrators call
    `record_arrival(req)` right after `scheduler.add_request(req)` so replay
    can reproduce the admission queue order exactly.
    """

    def __init__(self, inner: ExecutionBackend, sink: Sink = None) -> None:
        self.inner = inner
        self.writer = TraceWriter(sink)
        self._tick = 0
        self._last_preempts = 0
        self._header_written = False

    # ------------------------------------------------------------- forwarding
    @property
    def scheduler(self) -> PipelineScheduler:
        return self.inner.scheduler

    @scheduler.setter
    def scheduler(self, sched: PipelineScheduler) -> None:
        self.inner.scheduler = sched

    @property
    def depth(self) -> int:
        return self.inner.depth

    def clock(self) -> float:
        return self.inner.clock()

    def prepare(self, batch) -> Any:
        return self.inner.prepare(batch)

    def finish_request(self, req: Request) -> None:
        self.inner.finish_request(req)

    def __getattr__(self, name: str) -> Any:
        if name == "inner":
            raise AttributeError(name)
        return getattr(self.inner, name)

    # -------------------------------------------------------------- recording
    def _ensure_header(self) -> None:
        if not self._header_written:
            self.writer.write(scheduler_header(self.scheduler, self.depth))
            self._header_written = True

    def record_arrival(self, req: Request) -> None:
        """Log a request the moment it enters the scheduler's waiting queue."""
        self._ensure_header()
        self.writer.write({
            "kind": "req",
            "rid": req.request_id,
            "at": req.metrics.arrival_time,
            "prompt": list(req.prompt_token_ids),
            "max_new": req.sampling.max_new_tokens,
            "stop": list(req.sampling.stop_token_ids),
            "temp": req.sampling.temperature,
            # schema 1.2: scheduling class — admission order depends on it,
            # so replay must rebuild it or strict mode diverges
            "priority": req.sampling.priority,
            "slo": req.sampling.slo_class,
        })

    def record_abort(self, request_id: str, now: float) -> None:
        """A user abort was applied to the scheduler (repro.serving).
        Integrators call this right after `scheduler.abort_request` returns
        non-None, so replay applies the abort at the same stream position."""
        self._ensure_header()
        self.writer.write({"kind": "abort", "rid": request_id, "now": now})

    def record_scale_event(self, kind: str, now: float) -> None:
        """Elastic fleet lifecycle marker (schema 1.6): `scale_up` opens a
        freshly-added replica's stream, `drain` marks the instant this
        replica was masked from admission, `retire` is the last record a
        drained replica writes before its recorder closes.  Markers carry
        no scheduler state — replay re-records them verbatim (the request
        movement a drain causes is already fully described by the
        surrounding migrate/steal records)."""
        if kind not in ("scale_up", "drain", "retire"):
            raise ValueError(f"unknown scale event kind {kind!r}")
        self._ensure_header()
        self.writer.write({"kind": kind, "now": now})

    def record_migrate_out(self, request_id: str, now: float) -> None:
        """The control plane drained a request off this replica (§9)."""
        self.record_move_out(request_id, now, kind="migrate")

    def record_migrate_in(self, req: Request, now: float) -> None:
        self.record_move_in(req, now, kind="migrate")

    def record_move_out(self, request_id: str, now: float, *,
                        kind: str = "migrate") -> None:
        """The control plane drained a request off this replica — `kind`
        is "migrate" (§9 rebalance) or "handoff" (schema 1.5: the disagg
        prefill->decode transfer; identical layout, distinct intent)."""
        if kind not in ("migrate", "handoff"):
            raise ValueError(f"unknown move kind {kind!r}")
        self._ensure_header()
        self.writer.write({"kind": kind, "op": "out",
                           "rid": request_id, "now": now})

    def record_move_in(self, req: Request, now: float, *,
                       kind: str = "migrate") -> None:
        """The control plane adopted a request here at its current position
        (possibly mid-prefill: `prefilled` is the chunk cursor the
        destination resumes from).  The record embeds the full request
        state (progress, outputs so far, timing metrics), so this
        replica's trace replays stand-alone — replay re-materializes the
        migrant exactly as it arrived."""
        if kind not in ("migrate", "handoff"):
            raise ValueError(f"unknown move kind {kind!r}")
        self._ensure_header()
        m = req.metrics
        self.writer.write({
            "kind": kind, "op": "in",
            "rid": req.request_id,
            "now": now,
            "prompt": list(req.prompt_token_ids),
            "output": list(req.output_token_ids),
            "prefilled": req.num_prefilled,
            "state": req.state.value,
            "max_new": req.sampling.max_new_tokens,
            "stop": list(req.sampling.stop_token_ids),
            "temp": req.sampling.temperature,
            "priority": req.sampling.priority,
            "slo": req.sampling.slo_class,
            "arrival": m.arrival_time,
            "first_sched": m.first_scheduled_time,
            "first_token": m.first_token_time,
            "preemptions": m.num_preemptions,
        })

    def reset(self, now: float) -> None:
        self._ensure_header()
        self.writer.write({"kind": "reset", "now": now})
        self.inner.reset(now)

    def execute(self, ring, exiting_id, now) -> ExecResult:
        self._ensure_header()
        result = self.inner.execute(ring, exiting_id, now)
        # the recorder logs exit tokens at execute time, so a deferred
        # result is forced here — traced engines are synchronous by
        # construction (PipelineEngine rejects async_dispatch + trace_path)
        result.resolve()
        sched = self.scheduler
        entering_id = ring[0][0]
        batch = (sched.get_batch(entering_id)
                 if entering_id is not None else None)
        exit_rec = None
        if exiting_id is not None:
            exit_rec = {"id": exiting_id,
                        "tokens": [int(t) for t in result.tokens],
                        "at": result.completed_at}
        preempts = sched.stats.preemptions
        rec: Dict[str, Any] = {
            "kind": "tick",
            "tick": self._tick,
            "now": now,
            "batch": _batch_summary(batch),
        }
        if _pools(sched.kv) > 1:             # over data replicas, optional
            rec["replicas"] = _row_replicas(sched.kv, batch)
        rec.update({
            "prefill_budget": sched.stats.prefill_budgets[-1],
            "decode_budget": sched.stats.decode_budgets[-1],
            "kv_free": sched.kv.kv_free_rate,
            "wp": sched.num_waiting_prefill_tokens,
            "rd": sched.num_running_decode,
            "preempts": preempts - self._last_preempts,
            "stage_times": result.stage_times,
        })
        if sched.kv.enable_prefix_caching:   # schema 1.4, optional
            rec["cached"] = sched.stats.cached_prefill_tokens[-1]
        if result.host_s is not None:        # schema 1.3, optional per-backend
            rec["host_s"] = result.host_s
        rec["exit"] = exit_rec
        self.writer.write(rec)
        self._last_preempts = preempts
        self._tick += 1
        return result

    # ----------------------------------------------------------------- result
    @property
    def num_ticks(self) -> int:
        """Ticks recorded so far."""
        return self._tick

    def trace(self) -> Trace:
        """The recording so far, as an in-memory `Trace`."""
        return Trace.from_records(self.writer.records)

    def close(self) -> None:
        self.writer.close()


# ---------------------------------------------------------------------------
# Replay
# ---------------------------------------------------------------------------

class TraceBackend(ExecutionBackend):
    """The third `ExecutionBackend`: per-tick cost and tokens come from a
    recorded trace instead of a model or a roofline.

    strict mode (default) — asserts each tick's scheduler decision (batch
    composition, throttle budgets, KV/queue signals) matches the recording
    and returns the recorded tokens/latencies verbatim, so a full replay
    reproduces the original run bit-for-bit (requests, metrics, and a
    re-recorded trace all identical).  Divergence raises `TraceDivergence`
    with the tick index and field diff.

    timing-only mode — no assertions: the scheduler is free to decide
    differently (a *what-if* replay, e.g. after a policy change) while each
    tick still costs what the recorded tick cost.  Sampled tokens are
    placeholders when the recorded ones no longer line up.
    """

    STRICT = "strict"
    TIMING = "timing-only"

    def __init__(self, trace: Trace, mode: str = STRICT) -> None:
        if mode not in (self.STRICT, self.TIMING):
            raise ValueError(f"unknown replay mode {mode!r}")
        self.trace = trace
        self.mode = mode
        self._ticks = trace.ticks
        self._k = 0
        self._last_preempts = 0
        self._now = 0.0

    # --------------------------------------------------------------- protocol
    @property
    def depth(self) -> int:
        return self.trace.depth

    def clock(self) -> float:
        if self._k < len(self._ticks):
            return self._ticks[self._k]["now"]
        return self._now

    def reset(self, now: float) -> None:
        self._now = max(self._now, now)

    def execute(self, ring, exiting_id, now) -> ExecResult:
        self._now = max(self._now, now)
        rec = self._ticks[self._k] if self._k < len(self._ticks) else None
        k = self._k
        self._k += 1

        exiting = (self.scheduler.get_batch(exiting_id)
                   if exiting_id is not None else None)
        n_produce = (sum(1 for s in exiting.seqs if s.produces_token)
                     if exiting is not None else 0)

        if self.mode == self.STRICT:
            if rec is None:
                raise TraceDivergence(k, [
                    ("tick", "<end of trace>", "replay still has work")])
            self._check_tick(k, rec, ring, exiting_id, n_produce)
            if exiting_id is None:
                return ExecResult([], now, stage_times=rec["stage_times"],
                                  host_s=rec.get("host_s"))
            return ExecResult(list(rec["exit"]["tokens"]),
                              rec["exit"]["at"],
                              stage_times=rec["stage_times"],
                              host_s=rec.get("host_s"))

        # timing-only: recorded latency, scheduler free to diverge
        if rec is not None and rec["exit"] is not None:
            latency = max(0.0, rec["exit"]["at"] - rec["now"])
        else:
            latency = 0.0
        stage_times = rec["stage_times"] if rec is not None else None
        host_s = rec.get("host_s") if rec is not None else None
        if exiting_id is None:
            return ExecResult([], now, stage_times=stage_times, host_s=host_s)
        tokens = None
        if rec is not None and rec["exit"] is not None \
                and len(rec["exit"]["tokens"]) == n_produce:
            tokens = list(rec["exit"]["tokens"])
        return ExecResult(tokens if tokens is not None else [0] * n_produce,
                          now + latency, stage_times=stage_times,
                          host_s=host_s)

    # ------------------------------------------------------------- divergence
    def _check_tick(self, k: int, rec: Dict[str, Any], ring,
                    exiting_id: Optional[int], n_produce: int) -> None:
        sched = self.scheduler
        entering_id = ring[0][0]
        entering = (sched.get_batch(entering_id)
                    if entering_id is not None else None)
        actual = _batch_summary(entering)
        preempts = sched.stats.preemptions
        diffs: List[Tuple[str, Any, Any]] = []

        def cmp(fieldname: str, want: Any, got: Any) -> None:
            if want != got:
                diffs.append((fieldname, want, got))

        want_batch = rec["batch"]
        if (want_batch is None) != (actual is None):
            cmp("batch", want_batch, actual)
        elif want_batch is not None:
            cmp("batch.id", want_batch["id"], actual["id"])
            cmp("batch.prefill", want_batch["prefill"], actual["prefill"])
            cmp("batch.decode", want_batch["decode"], actual["decode"])
        if "replicas" in rec:                # over data replicas
            cmp("replicas", rec["replicas"],
                _row_replicas(sched.kv, entering))
        cmp("prefill_budget", rec["prefill_budget"],
            sched.stats.prefill_budgets[-1])
        cmp("decode_budget", rec["decode_budget"],
            sched.stats.decode_budgets[-1])
        cmp("kv_free", rec["kv_free"], sched.kv.kv_free_rate)
        cmp("wp", rec["wp"], sched.num_waiting_prefill_tokens)
        cmp("rd", rec["rd"], sched.num_running_decode)
        cmp("preempts", rec["preempts"], preempts - self._last_preempts)
        if "cached" in rec:                  # schema 1.4: prefix-cache adoption
            cmp("cached", rec["cached"],
                sched.stats.cached_prefill_tokens[-1])
        want_exit = rec["exit"]
        if (want_exit is None) != (exiting_id is None):
            cmp("exit", want_exit,
                None if exiting_id is None else {"id": exiting_id})
        elif want_exit is not None:
            cmp("exit.id", want_exit["id"], exiting_id)
            cmp("exit.num_tokens", len(want_exit["tokens"]), n_produce)
        self._last_preempts = preempts
        if diffs:
            raise TraceDivergence(k, diffs)


@dataclass
class ReplayReport:
    """Outcome of one replay: the requests as re-materialized by the replayed
    scheduler, plus the re-recorded trace when requested."""

    mode: str
    ticks: int
    finished: List[Request]
    scheduler: PipelineScheduler
    recorded: Optional[Trace] = None

    def request_metrics(self) -> Dict[str, Tuple[Optional[float],
                                                 Optional[float], int]]:
        """rid -> (ttft, e2el, num_output_tokens) — the comparison surface
        for determinism tests (two replays must agree exactly)."""
        return {r.request_id: (r.metrics.ttft(), r.metrics.e2el(),
                               r.num_output_tokens)
                for r in self.finished}

    def outputs(self) -> Dict[str, List[int]]:
        return {r.request_id: list(r.output_token_ids)
                for r in self.finished}

    def summary(self) -> str:
        """One-line human summary — shared by every --trace-replay CLI."""
        ttfts = [r.metrics.ttft() for r in self.finished
                 if r.metrics.ttft() is not None]
        return (f"{self.mode} replay — {self.ticks} ticks, "
                f"{len(self.finished)} requests, "
                f"{sum(r.num_output_tokens for r in self.finished)} tokens, "
                f"TTFT_mean={float(np.mean(ttfts or [0])):.4f}s")


def _sampling_from_record(rec: Dict[str, Any]) -> SamplingParams:
    """Shared by req + migrate-in records.  Pre-1.2 traces carry no
    priority/slo fields; the defaults reproduce their recorded scheduling
    exactly (all-default queues admit in FCFS order)."""
    return SamplingParams(max_new_tokens=rec["max_new"],
                          temperature=rec.get("temp", 0.0),
                          stop_token_ids=tuple(rec.get("stop", ())),
                          priority=int(rec.get("priority", 0)),
                          slo_class=rec.get("slo", "interactive"))


def request_from_record(rec: Dict[str, Any]) -> Request:
    req = Request(rec["rid"], list(rec["prompt"]), _sampling_from_record(rec))
    req.metrics.arrival_time = rec["at"]
    return req


def migrated_request_from_record(rec: Dict[str, Any]) -> Request:
    """Re-materialize a migrant exactly as it arrived: progress, outputs so
    far, and cross-replica timing metrics all come from the record."""
    req = Request(rec["rid"], list(rec["prompt"]), _sampling_from_record(rec))
    req.output_token_ids = list(rec["output"])
    req.num_prefilled = int(rec["prefilled"])
    req.state = RequestState(rec["state"])
    m = req.metrics
    m.arrival_time = rec["arrival"]
    m.first_scheduled_time = rec.get("first_sched")
    m.first_token_time = rec.get("first_token")
    m.num_preemptions = int(rec.get("preemptions", 0))
    return req


def replay_trace(trace: Trace, *, mode: str = TraceBackend.STRICT,
                 record_to: Sink = None, record: bool = False,
                 scheduler: Optional[PipelineScheduler] = None,
                 max_extra_ticks: int = 100000) -> ReplayReport:
    """Drive the recorded event stream through a fresh scheduler + TickLoop.

    Records are applied in stream order: `req` records enter the waiting
    queue (reproducing admission order), `tick` records step the loop at the
    recorded time, `reset` records abort in-flight work.  With `record=True`
    (or a `record_to` sink) the replay is itself recorded — the round-trip
    determinism check compares that re-recording against the original.

    Passing `scheduler` overrides the header-built one — the what-if knob:
    replay the recorded workload and latencies under a *different* policy
    (use timing-only mode; a changed policy will diverge under strict).
    """
    sched = scheduler or scheduler_from_header(trace.header)
    backend = TraceBackend(trace, mode=mode)
    recorder: Optional[TraceRecorder] = None
    loop_backend: ExecutionBackend = backend
    if record or record_to is not None:
        recorder = TraceRecorder(backend, record_to)
        loop_backend = recorder
    loop = TickLoop(sched, loop_backend)

    now = 0.0
    for rec in trace.records:
        kind = rec["kind"]
        if kind == "req":
            req = request_from_record(rec)
            sched.add_request(req)
            if recorder is not None:
                recorder.record_arrival(req)
        elif kind == "tick":
            now = rec["now"]
            loop.step(now)
        elif kind == "reset":
            loop.abort_inflight()
            now = rec["now"]
            loop_backend.reset(now)
        elif kind == "abort":
            # user aborts are part of the workload: re-apply at the recorded
            # stream position (in-flight ones finalize at the next retire,
            # exactly as they did live)
            req = sched.abort_request(rec["rid"], rec["now"])
            if req is not None and req.is_finished:
                loop.finished.append(req)
            if recorder is not None:
                recorder.record_abort(rec["rid"], rec["now"])
        elif kind in ("migrate", "handoff"):
            # control-plane moves are applied in stream order, exactly where
            # the recording interleaved them between ticks (§9); "handoff"
            # (schema 1.5) is the disagg prefill->decode transfer — same
            # drain/adopt semantics, re-recorded under its own kind
            if rec["op"] == "out":
                drained = sched.drain_request(rec["rid"])
                if drained is not None and sched.kv.has_request(rec["rid"]):
                    sched.kv.free(rec["rid"])
                if recorder is not None:
                    recorder.record_move_out(rec["rid"], rec["now"],
                                             kind=kind)
            else:
                req = migrated_request_from_record(rec)
                if req.num_prefilled:
                    # placed as the live engine's `import_kv` places it
                    sched.kv.place(req.request_id,
                                   range(_pools(sched.kv)))
                    sched.kv.allocate(req.request_id, req.num_prefilled)
                sched.adopt_request(req)
                if recorder is not None:
                    recorder.record_move_in(req, rec["now"], kind=kind)
        elif kind in ("scale_up", "drain", "retire"):
            # elastic lifecycle markers (schema 1.6): no scheduler state
            # change — the request movement a drain causes is already in
            # the stream as migrate/steal records.  Re-record verbatim so
            # elastic traces round-trip byte-identically.
            if recorder is not None:
                recorder.record_scale_event(kind, rec["now"])
        elif kind == "route":  # router streams are not tick traces
            raise TraceSchemaError(
                "route records belong to a gllm-route trace, not a replayable "
                "tick trace")

    if mode == TraceBackend.STRICT:
        if loop.has_work:
            raise TraceDivergence(backend._k, [
                ("end", "<all work retired>",
                 f"pending work after final recorded tick "
                 f"(waiting={len(sched.waiting)}, busy={loop.busy})")])
    else:
        # what-if replays may need more (or fewer) ticks than were recorded
        t = 0
        while loop.has_work and t < max_extra_ticks:
            now += 1e-3
            loop.step(now)
            t += 1

    recorded = recorder.trace() if recorder is not None else None
    if recorder is not None:
        recorder.close()
    return ReplayReport(mode=mode, ticks=backend._k, finished=loop.finished,
                        scheduler=sched, recorded=recorded)


# ---------------------------------------------------------------------------
# Calibration surface (consumed by CostModel.fit_from_trace)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TickSample:
    """Per-tick workload + observed per-stage service time, in exactly the
    terms `CostModel.stage_time` speaks."""

    prefill_tokens: int
    decode_tokens: int
    prefill_ctx: int
    decode_ctx: int
    stage_time: float       # un-straggled per-stage latency (min over stages)
    host_s: Optional[float] = None   # per-tick host overhead (schema 1.3)


def tick_samples(trace: Trace) -> List[TickSample]:
    """Non-empty ticks that recorded per-stage latencies (backends that
    cannot attribute time per stage record null and are skipped)."""
    out: List[TickSample] = []
    for rec in trace.ticks:
        batch, times = rec["batch"], rec["stage_times"]
        if batch is None or not times:
            continue
        pf, dc = batch["prefill"], batch["decode"]
        p_ctx = max((e[1] + e[2] for e in pf), default=0)
        d_ctx = int(np.mean([e[1] for e in dc])) if dc else 0
        out.append(TickSample(
            prefill_tokens=sum(e[2] for e in pf),
            decode_tokens=len(dc),
            prefill_ctx=p_ctx,
            decode_ctx=d_ctx,
            stage_time=float(min(times)),
            host_s=rec.get("host_s"),
        ))
    return out


def host_overhead_samples(trace: Trace) -> List[float]:
    """Per-tick `host_s` values of non-bubble ticks (schema ≥ 1.3).  Empty
    for traces whose backend reported no host overhead."""
    return [float(rec["host_s"]) for rec in trace.ticks
            if rec.get("host_s") is not None and rec["batch"] is not None]


def calibration_error(trace: Trace, cost) -> float:
    """Mean relative error of `cost.stage_time` against the recorded
    per-stage latencies — the sim-vs-engine closure bound."""
    samples = tick_samples(trace)
    if not samples:
        raise ValueError("trace has no ticks with stage latencies")
    errs = []
    for s in samples:
        pred = cost.stage_time(s.prefill_tokens, s.decode_tokens,
                               s.prefill_ctx, s.decode_ctx)
        errs.append(abs(pred - s.stage_time) / max(s.stage_time, 1e-12))
    return float(np.mean(errs))


# ---------------------------------------------------------------------------
# CLI — `check` replays the checked-in golden traces
# ---------------------------------------------------------------------------

def check_trace(path: str) -> ReplayReport:
    """Strict replay + re-record; raises on divergence or non-determinism.
    Compacted traces are expanded on load, so the identity is checked against
    the canonical (expanded) byte stream either way."""
    with open(path) as fh:
        raw = fh.read()
    trace = Trace.loads(raw)
    original = trace.dumps()
    report = replay_trace(trace, record=True)
    rerecorded = report.recorded.dumps()
    if rerecorded != original:
        # line-level pinpoint for the report
        for i, (a, b) in enumerate(zip(original.splitlines(),
                                       rerecorded.splitlines())):
            if a != b:
                raise TraceDivergence(i, [("line", a, b)])
        raise TraceDivergence(-1, [("length", len(original),
                                    len(rerecorded))])
    return report


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="repro_torch.runtime.trace",
        description="record/replay tooling for gLLM tick traces")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_check = sub.add_parser("check", help="strict replay + round-trip "
                             "identity (golden-trace gate)")
    p_check.add_argument("paths", nargs="+")
    p_replay = sub.add_parser("replay", help="replay one trace")
    p_replay.add_argument("path")
    p_replay.add_argument("--timing-only", action="store_true",
                          help="what-if replay: recorded latencies, free "
                          "scheduler decisions")
    p_fit = sub.add_parser("fit", help="calibrate CostModel from a trace")
    p_fit.add_argument("path")
    p_fit.add_argument("--arch", default="qwen2.5-14b")
    p_fit.add_argument("--pp", type=int, default=None)
    p_compact = sub.add_parser(
        "compact", help="delta-encode a trace (lossless; replays and "
        "checks identically)")
    p_compact.add_argument("path")
    p_compact.add_argument("-o", "--out", default=None,
                           help="output path (default: PATH.compact)")
    args = ap.parse_args(argv)

    if args.cmd == "check":
        for path in args.paths:
            report = check_trace(path)
            print(f"{path}: OK — {report.ticks} ticks, "
                  f"{len(report.finished)} requests, round-trip identical")
        return 0
    if args.cmd == "replay":
        mode = TraceBackend.TIMING if args.timing_only else TraceBackend.STRICT
        report = replay_trace(Trace.load(args.path), mode=mode)
        print(f"{args.path}: {report.summary()}")
        return 0
    if args.cmd == "fit":
        from repro_torch.configs import get_config
        from repro_torch.runtime.simulator import CostModel, cost_model_for

        trace = Trace.load(args.path)
        base = cost_model_for(get_config(args.arch),
                              pp=args.pp or trace.depth)
        fitted = CostModel.fit_from_trace(trace, base)
        err = calibration_error(trace, fitted)
        print(f"{args.path}: fitted mfu={fitted.mfu:.4f} "
              f"hbm_eff={fitted.hbm_eff:.4f} fixed_us={fitted.fixed_us:.2f} "
              f"| mean relative error {err:.3%}")
        return 0
    if args.cmd == "compact":
        with open(args.path) as fh:
            records = [json.loads(line) for line in fh if line.strip()]
        compacted = compact_records(records)
        out_path = args.out or args.path + ".compact"
        raw = "\n".join(dumps_record(r) for r in records) + "\n"
        small = "\n".join(dumps_record(r) for r in compacted) + "\n"
        # lossless by construction — verify anyway, BEFORE any artifact
        # exists on disk
        if Trace.loads(small).dumps() != Trace.loads(raw).dumps():
            raise TraceSchemaError(
                f"compaction of {args.path} did not round-trip losslessly; "
                "refusing to write output")
        with open(out_path, "w") as fh:
            fh.write(small)
        print(f"{args.path}: {len(raw)} -> {len(small)} bytes "
              f"({len(small) / max(len(raw), 1):.1%}) -> {out_path}")
        return 0
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
