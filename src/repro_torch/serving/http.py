"""HTTP serving frontend: the real frontend *process* over `LLMServer`
(DESIGN.md §11).

A copy of ``repro.serving.http``: the port keeps its own so that it imports
nothing of the JAX package.

Stdlib-only (`http.server.ThreadingHTTPServer` — no new dependencies): one
handler thread per connection, all of them driving the one `LLMServer`
underneath.  Steps serialize on the server's lock, so N concurrent clients
interleave safely on any substrate a `ServeSpec` can build — one engine,
or a multi-replica cluster (heterogeneous ones declared by
`ClusterSpec.capacities`).

Endpoints (all bodies JSON):

  POST   /v1/generate            sync: {"prompt": [ids], ...} -> the
                                 finished request (token_ids, finish_reason,
                                 ttft/e2el metrics)
  POST   /v1/generate?stream=1   chunked SSE: one ``data:`` frame per
                                 `TokenDelta`, including ``event="preempt"``
                                 lifecycle frames; the last frame carries
                                 `finish_reason`
  DELETE /v1/requests/{rid}      abort a request anywhere in its life
  GET    /v1/stats               the `LLMServer.stats()` snapshot: per-replica
                                 scheduler/KV signals incl. the service-rate
                                 EWMA and waiting-queue SLO-class composition

Request fields beyond ``prompt`` map 1:1 onto `SamplingParams` —
``max_new_tokens``, ``temperature``, ``top_k``, ``top_p``,
``stop_token_ids``, and the scheduling class: ``priority`` (int, higher
admits first within a class) and ``slo_class`` (``"interactive"`` |
``"batch"``) — which Token Throttling's admission and preemption honor
(core/scheduler.py, DESIGN.md §11).  OpenAI-compatible spellings are
accepted as aliases: ``max_tokens`` (= max_new_tokens), ``stop`` (= stop
token ids — prompts are token-id lists, so stops are too), and a
``"stream": true`` body field (= ``?stream=1``); non-streaming responses
carry an OpenAI-completions ``choices``/``usage`` shape alongside the
native fields.

Serve from the launcher::

    PYTHONPATH=src python -m repro_torch.launch.serve --http 8000 \
        --bucketed --async                    # or any flag combination

    curl -s localhost:8000/v1/generate -d '{"prompt": [1,2,3]}'
    curl -sN 'localhost:8000/v1/generate?stream=1' \
        -d '{"prompt": [1,2,3], "slo_class": "batch"}'
    curl -s -X DELETE localhost:8000/v1/requests/llm-0
    curl -s localhost:8000/v1/stats

or programmatically (`port=0` binds an ephemeral port — the test path)::

    frontend = HTTPFrontend(build(spec), port=0).start()
    ... requests against f"http://127.0.0.1:{frontend.port}" ...
    frontend.shutdown()
"""

from __future__ import annotations

import dataclasses
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional
from urllib.parse import parse_qs, urlparse

from repro_torch.core import SamplingParams
from repro_torch.serving.server import LLMServer, RequestOutput, TokenDelta

# SamplingParams fields settable over the wire, with their coercions.
_SAMPLING_FIELDS = {
    "max_new_tokens": int,
    "temperature": float,
    "top_k": int,
    "top_p": float,
    "stop_token_ids": lambda v: tuple(int(t) for t in v),
    "priority": int,
    "slo_class": str,
}

# OpenAI-compatible field names, accepted as aliases of the native ones
# (prompts stay token-id lists; `stop` is therefore a list of stop token
# ids, not strings).  `stream` may also arrive as a body field instead of
# the `?stream=1` query parameter.
_OPENAI_ALIASES = {
    "max_tokens": "max_new_tokens",
    "stop": "stop_token_ids",
}


class BadRequest(ValueError):
    """Client error: reported as a 400 with the message in the body."""


def sampling_from_json(body: Dict[str, Any]) -> SamplingParams:
    """`SamplingParams` from a request body's non-``prompt`` fields.
    OpenAI-style aliases (`max_tokens`, `stop`) map onto the native
    names; unknown fields are rejected (same contract as the spec layer:
    a typo'd knob must not silently serve a different request)."""
    kw = {}
    for name, value in body.items():
        if name in ("prompt", "request_id", "stream"):
            continue
        native = _OPENAI_ALIASES.get(name, name)
        co = _SAMPLING_FIELDS.get(native)
        if co is None:
            raise BadRequest(
                f"unknown request field {name!r}; expected prompt, "
                f"request_id, stream, one of {sorted(_SAMPLING_FIELDS)}, "
                f"or an alias {sorted(_OPENAI_ALIASES)}")
        if native in kw:
            raise BadRequest(
                f"field {name!r} duplicates {native!r}; send one or the "
                "other")
        try:
            kw[native] = co(value)
        except (TypeError, ValueError) as e:
            raise BadRequest(f"bad value for {name!r}: {e}")
    try:
        return SamplingParams(**kw)
    except ValueError as e:         # e.g. unknown slo_class
        raise BadRequest(str(e))


def stream_requested(body: Dict[str, Any], query: Dict[str, Any]) -> bool:
    """``?stream=1`` or an OpenAI-style ``"stream": true`` body field."""
    if query.get("stream", ["0"])[0] in ("1", "true"):
        return True
    flag = body.get("stream", False)
    if not isinstance(flag, bool):
        raise BadRequest('"stream" must be a JSON boolean')
    return flag


def _prompt_from_json(body: Dict[str, Any]) -> list:
    prompt = body.get("prompt")
    if not isinstance(prompt, list) or not prompt \
            or not all(isinstance(t, int) and not isinstance(t, bool)
                       for t in prompt):
        raise BadRequest('"prompt" must be a non-empty list of token ids')
    return prompt


def output_to_json(out: RequestOutput) -> Dict[str, Any]:
    """Finished-request body: OpenAI-completions-shaped (`choices` +
    `usage`) with the repo-native fields kept alongside, so both client
    generations read one response."""
    m = out.metrics
    return {
        "id": out.request_id,
        "object": "completion",
        "request_id": out.request_id,
        "prompt_tokens": len(out.prompt_token_ids),
        "token_ids": list(out.token_ids),
        "finish_reason": out.finish_reason,
        "choices": [{
            "index": 0,
            "token_ids": list(out.token_ids),
            "finish_reason": out.finish_reason,
        }],
        "usage": {
            "prompt_tokens": len(out.prompt_token_ids),
            "completion_tokens": len(out.token_ids),
            "total_tokens": len(out.prompt_token_ids) + len(out.token_ids),
        },
        "metrics": {
            "ttft": m.ttft(),
            "e2el": m.e2el(),
            "num_preemptions": m.num_preemptions,
        },
    }


def delta_to_json(delta: TokenDelta) -> Dict[str, Any]:
    return {
        "request_id": delta.request_id,
        "token": delta.token,
        "index": delta.index,
        "finish_reason": delta.finish_reason,
        "event": delta.event,
    }


def stats_to_json(stats) -> Dict[str, Any]:
    out: Dict[str, Any] = {
        "replicas": [dataclasses.asdict(r) for r in stats.replicas],
        "tokens_retired": stats.tokens_retired,
    }
    if stats.routed_counts is not None:
        out["routed_counts"] = list(stats.routed_counts)
    if stats.replica_ordinals is not None:
        out["replica_ordinals"] = list(stats.replica_ordinals)
    if stats.rebalance is not None:
        out["rebalance"] = dataclasses.asdict(stats.rebalance)
    if stats.disagg is not None:
        # disaggregated deployments (DESIGN.md §15): handoff counters plus
        # the per-role queue split operators watch to size the role ratio
        out["disagg"] = dataclasses.asdict(stats.disagg)
        out["queue_depth_by_role"] = stats.queue_depth_by_role
    if stats.fleet_size is not None:
        # elastic fleets (DESIGN.md §16): serving size, active drains,
        # retirements — plus the scaling event log when the autoscaler runs
        out["fleet_size"] = stats.fleet_size
        out["draining"] = stats.draining
        out["retired"] = stats.retired
    if stats.autoscale is not None:
        auto = dataclasses.asdict(stats.autoscale)
        auto["events"] = [list(e) for e in auto["events"]]
        out["autoscale"] = auto
    if stats.attainment_by_class is not None:
        out["attainment_by_class"] = stats.attainment_by_class
    return out


class _Handler(BaseHTTPRequestHandler):
    """One instance per connection; `llm` is set on the subclass by
    `HTTPFrontend`.  HTTP/1.1 so SSE can use chunked transfer encoding."""

    llm: LLMServer = None           # type: ignore[assignment]
    protocol_version = "HTTP/1.1"

    # ------------------------------------------------------------- plumbing
    def log_message(self, fmt, *args):  # quiet by default; tests and the
        pass                            # launcher print their own lines

    def _read_json(self) -> Dict[str, Any]:
        length = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(length) if length else b""
        if not raw:
            raise BadRequest("empty body; expected a JSON object")
        try:
            body = json.loads(raw)
        except json.JSONDecodeError as e:
            raise BadRequest(f"body is not valid JSON: {e}")
        if not isinstance(body, dict):
            raise BadRequest("body must be a JSON object")
        return body

    def _send_json(self, obj: Any, status: int = 200) -> None:
        data = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send_error_json(self, status: int, message: str) -> None:
        self._send_json({"error": message}, status=status)

    # --------------------------------------------------------------- routes
    def do_POST(self) -> None:
        url = urlparse(self.path)
        if url.path != "/v1/generate":
            self._send_error_json(404, f"no such endpoint: POST {url.path}")
            return
        try:
            body = self._read_json()
            prompt = _prompt_from_json(body)
            sampling = sampling_from_json(body)
            rid = body.get("request_id")
            stream = stream_requested(body, parse_qs(url.query))
            if stream:
                self._stream_generate(prompt, sampling, rid)
            else:
                out = self.llm.generate(prompt, sampling, request_id=rid)
                self._send_json(output_to_json(out))
        except BadRequest as e:
            self._send_error_json(400, str(e))
        except ValueError as e:     # substrate admission errors (too long…)
            self._send_error_json(400, str(e))

    def do_DELETE(self) -> None:
        url = urlparse(self.path)
        prefix = "/v1/requests/"
        if not url.path.startswith(prefix) or url.path == prefix:
            self._send_error_json(404, f"no such endpoint: DELETE {url.path}")
            return
        rid = url.path[len(prefix):]
        found = self.llm.abort(rid)
        if not found:
            self._send_error_json(404, f"unknown request id {rid!r}")
            return
        self._send_json({"request_id": rid, "aborted": True})

    def do_GET(self) -> None:
        url = urlparse(self.path)
        if url.path == "/v1/stats":
            self._send_json(stats_to_json(self.llm.stats()))
            return
        if url.path == "/healthz":
            self._send_json({"ok": True})
            return
        self._send_error_json(404, f"no such endpoint: GET {url.path}")

    # ------------------------------------------------------------ streaming
    def _stream_generate(self, prompt, sampling,
                         rid: Optional[str]) -> None:
        """Chunked SSE: one ``data:`` frame per `TokenDelta`.  The handler
        thread itself steps the substrate (`LLMServer.stream`), so a lone
        streaming client makes progress without any background runner;
        concurrent handlers interleave on the step lock."""
        # submit happens here, eagerly — admission errors become a 400
        # (raised to do_POST) instead of a truncated event stream
        deltas = self.llm.stream(prompt, sampling, request_id=rid)
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        try:
            for delta in deltas:
                frame = ("data: " + json.dumps(delta_to_json(delta))
                         + "\n\n").encode()
                self._write_chunk(frame)
            self._write_chunk(b"")          # terminating 0-length chunk
        except (BrokenPipeError, ConnectionResetError):
            pass                            # client went away mid-stream

    def _write_chunk(self, data: bytes) -> None:
        self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()


class HTTPFrontend:
    """The frontend process: a `ThreadingHTTPServer` over one `LLMServer`.

    `port=0` binds an ephemeral port (read it back from `.port`).  `start()`
    serves on a daemon thread and returns self — the programmatic/test
    path; `serve_forever()` blocks — the launcher path."""

    def __init__(self, server: LLMServer, host: str = "127.0.0.1",
                 port: int = 8000) -> None:
        self.llm = server
        handler = type("BoundHandler", (_Handler,), {"llm": server})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.host, self.port = self.httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "HTTPFrontend":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def shutdown(self) -> None:
        self.httpd.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.httpd.server_close()
        self.llm.close()
