"""The port's async double-buffered `TickLoop` (`runtime/core.py`), a copy
of the JAX package's (`repro/runtime/core.py:179-320`), and the engine
around it on the CPU.

With `async_dispatch=True` a tick's exiting batch is retired one step later,
after the next tick has been dispatched, unless its readback is already
ready at the top of that step, in which case it is retired before the
scheduler runs.  A step whose batch is empty while nothing is in flight
retires the deferred batch without a device tick.  A stub backend pins
these orders (its `ready()` under the test's control); the port's engine
pins that async dispatch changes neither tokens nor, on the CPU (where
`ready()` is always true), the tick count, and that deferring every
readback (ready never true) changes the tokens of no request.
"""

import dataclasses

import numpy as np
import pytest

from repro_torch.configs import get_config, make_reduced
from repro_torch.core import (
    PagedKVManager,
    PipelineScheduler,
    SamplingParams,
    ThrottleConfig,
)
from repro_torch.models.serve import ServeDims
from repro_torch.models.transformer import init_params
from repro_torch.runtime.core import ExecResult, ExecutionBackend, TickLoop
from repro_torch.runtime.engine import PipelineEngine

DIMS = dict(Sp=1, C=16, Sd=8, pages=256, page=8, Bp=32, Bd=32, slots=16)
THROTTLE = dict(pipeline_depth=1, max_prefill_tokens=16,
                min_prefill_tokens=4, num_iters_T=2)


class StubBackend(ExecutionBackend):
    """Depth-1 backend whose tokens are the tick number; logs every
    execute and every readback, and reports ready per `self.ready`."""

    def __init__(self) -> None:
        self.log = []
        self.ticks = 0
        self.ready = True

    @property
    def depth(self) -> int:
        return 1

    def execute(self, ring, exiting_id, now):
        self.ticks += 1
        tick = self.ticks
        self.log.append(("execute", tick))
        batch = (self.scheduler.get_batch(exiting_id)
                 if exiting_id is not None else None)
        if batch is None:
            return ExecResult(completed_at=now)
        n = sum(1 for s in batch.seqs if s.produces_token)

        def readback():
            self.log.append(("readback", tick))
            return [tick] * n

        return ExecResult(completed_at=now, pending=readback,
                          ready=lambda: self.ready)


def _loop(async_dispatch=True):
    kv = PagedKVManager(64, 8)
    sched = PipelineScheduler(ThrottleConfig(**THROTTLE), kv,
                              max_model_len=256, max_prefill_seqs=1,
                              max_chunk_tokens=16, max_decode_seqs=8)
    backend = StubBackend()
    return TickLoop(sched, backend, async_dispatch=async_dispatch), backend


def _add(loop, n_prompt, max_new, rid):
    from repro_torch.core import Request
    req = Request(rid, list(range(1, n_prompt + 1)),
                  SamplingParams(max_new_tokens=max_new))
    loop.scheduler.add_request(req)
    return req


# prompts of 3 tokens are one prefill chunk (below min_prefill_tokens),
# which produces a token


def test_not_ready_readback_retires_after_the_next_dispatch():
    loop, backend = _loop()
    backend.ready = False
    a, b = _add(loop, 3, 3, "a"), _add(loop, 3, 3, "b")
    loop.step(0.0)                      # a's prefill
    assert backend.log == [("execute", 1)]
    assert loop.busy and not a.output_token_ids        # deferred
    loop.step(1.0)                      # b's prefill (a is still in flight)
    # tick 2 was dispatched before tick 1's readback was forced
    assert backend.log == [("execute", 1), ("execute", 2), ("readback", 1)]
    assert a.output_token_ids == [1] and not b.output_token_ids


def test_ready_readback_retires_before_scheduling():
    loop, backend = _loop()
    req = _add(loop, 3, 3, "a")
    loop.step(0.0)
    loop.step(1.0)
    # tick 1 was ready: retired at the top of step 2, before its execute,
    # so its request decoded in tick 2
    assert backend.log[:3] == [("execute", 1), ("readback", 1),
                               ("execute", 2)]
    assert req.output_token_ids == [1]


def test_empty_batch_retires_pending_without_a_tick():
    """The last deferred batch is retired without a bubble tick, whether
    its readback was ready at the top of the step or not."""
    for ready in (True, False):
        loop, backend = _loop()
        backend.ready = ready
        req = _add(loop, 3, 1, "a")
        loop.step(0.0)                  # prefill produces the only token
        assert loop.busy
        finished = loop.step(1.0)
        assert finished == [req] and req.is_finished
        assert backend.ticks == 1 and not loop.busy


@pytest.mark.parametrize("ready", [True, False])
def test_async_and_sync_loops_retire_the_same_tokens(ready):
    outs, ticks = {}, {}
    for mode in (False, True):
        loop, backend = _loop(async_dispatch=mode)
        backend.ready = ready
        reqs = [_add(loop, n, 4, f"r{i}") for i, n in enumerate((5, 20, 9))]
        loop.drain(lambda: 0.0)
        assert all(r.is_finished for r in reqs)
        outs[mode] = [len(r.output_token_ids) for r in reqs]
        ticks[mode] = backend.ticks
    assert outs[True] == outs[False] == [4, 4, 4]
    if ready:
        assert ticks[True] == ticks[False]
    else:
        assert ticks[True] >= ticks[False]


def test_abort_inflight_drops_the_deferred_batch():
    loop, backend = _loop()
    backend.ready = False
    req = _add(loop, 3, 3, "a")
    loop.step(0.0)
    assert loop._pending is not None
    affected = loop.abort_inflight(1.0)
    assert req in affected and loop._pending is None and not loop.busy
    assert ("readback", 1) not in backend.log       # never forced
    loop.drain(lambda: 2.0)                         # recompute completes
    assert req.is_finished and req.num_output_tokens == 3


# ------------------------------------------------------------------ engine

def _engine(**kw):
    cfg = make_reduced(get_config("qwen1.5-0.5b")).with_plan(pp=1, tp=1)
    cfg = dataclasses.replace(cfg, dtype="float32")
    return cfg, PipelineEngine(cfg, ServeDims(**DIMS), init_params(cfg, 0),
                               ThrottleConfig(**THROTTLE), device="cpu", **kw)


def _serve(cfg, eng, never_ready=False):
    if never_ready:
        inner = eng.backend.execute

        def execute(*args):
            res = inner(*args)
            if res.pending is not None:
                res.ready = lambda: False
            return res

        eng.backend.execute = execute
    rng = np.random.default_rng(7)
    reqs = [eng.add_request([int(t) for t in rng.integers(0, cfg.vocab_size,
                                                          n)],
                            SamplingParams(max_new_tokens=5))
            for n in (6, 19, 33, 3)]
    eng.drain(max_ticks=500)
    assert all(r.is_finished for r in reqs)
    return [r.output_token_ids for r in reqs], eng.stats.ticks


@pytest.mark.parametrize("bucketed", [False, True])
def test_engine_async_matches_sync(bucketed):
    cfg, eng = _engine(bucketed=bucketed)
    want, sync_ticks = _serve(cfg, eng)
    cfg, eng = _engine(bucketed=bucketed, async_dispatch=True)
    got, async_ticks = _serve(cfg, eng)
    assert got == want and async_ticks == sync_ticks
    cfg, eng = _engine(bucketed=bucketed, async_dispatch=True)
    late, late_ticks = _serve(cfg, eng, never_ready=True)
    assert late == want and late_ticks >= sync_ticks


def test_engine_async_readbacks_use_both_ring_buffers():
    """Consecutive ticks read back through alternate pinned buffers, so a
    deferred readback is never overwritten by the tick dispatched after
    it."""
    cfg, eng = _engine(bucketed=True, async_dispatch=True)
    seen = []
    inner = eng.backend.execute

    def execute(*args):
        seen.append(eng.backend._ring_slot)
        return inner(*args)

    eng.backend.execute = execute
    _serve(cfg, eng)
    assert seen[:4] == [0, 1, 0, 1]
