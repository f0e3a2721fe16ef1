"""HTTP frontend conformance of the port (`repro_torch.serving.http`): the
15 cases of tests/test_http.py against `HTTPFrontend(build(spec), port=0)`
over a reduced `TorchBackend` engine on the CPU (the JAX suite serves a
simulator spec; tests/test_torch_sim_serving.py serves the port's over
HTTP).

Generate (sync), streaming SSE (incl. mid-stream abort), DELETE-abort,
stats, request validation, the OpenAI-shaped surface, and a declared
heterogeneous two-engine cluster end-to-end over HTTP; stdlib http on the
client side, loopback only.
"""

import json
import threading
import urllib.error
import urllib.request

import pytest

from repro_torch.serving import (ClusterSpec, EngineSpec, HTTPFrontend,
                                 ReplicaCapacity, ServeSpec, build)

# the reduced engine at the launcher's reduced dims: 512 tokens a request,
# room for test_abort_mid_stream's 8 + 500
ENGINE = EngineSpec(arch="qwen1.5-0.5b")
SPEC = ServeSpec(engine=ENGINE)


@pytest.fixture()
def frontend():
    fe = HTTPFrontend(build(SPEC, device="cpu"), port=0).start()
    yield fe
    fe.shutdown()


def _post(url, body, **kw):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 method="POST", **kw)
    return urllib.request.urlopen(req, timeout=30)


def _json(resp):
    return json.loads(resp.read())


def _sse_frames(resp):
    """Decode an SSE stream into the JSON payloads, as they arrive."""
    for line in resp:
        line = line.decode().strip()
        if line.startswith("data: "):
            yield json.loads(line[len("data: "):])


# ---------------------------------------------------------------------------
# generate / stream / abort / stats
# ---------------------------------------------------------------------------

def test_generate_sync(frontend):
    out = _json(_post(frontend.url + "/v1/generate",
                      {"prompt": [1, 2, 3, 4], "max_new_tokens": 5}))
    assert out["finish_reason"] == "length"
    assert len(out["token_ids"]) == 5
    assert out["prompt_tokens"] == 4
    assert out["metrics"]["ttft"] is not None
    assert out["metrics"]["e2el"] >= out["metrics"]["ttft"]


def test_generate_honors_request_id_and_slo_fields(frontend):
    out = _json(_post(frontend.url + "/v1/generate",
                      {"prompt": [9] * 8, "max_new_tokens": 2,
                       "request_id": "mine", "slo_class": "batch",
                       "priority": 3}))
    assert out["request_id"] == "mine"
    assert out["finish_reason"] == "length"


def test_stream_sse(frontend):
    resp = _post(frontend.url + "/v1/generate?stream=1",
                 {"prompt": [5, 6, 7], "max_new_tokens": 4})
    assert resp.headers["Content-Type"] == "text/event-stream"
    frames = list(_sse_frames(resp))
    tokens = [f for f in frames if f["token"] is not None]
    assert len(tokens) == 4
    assert [f["index"] for f in tokens] == [1, 2, 3, 4]
    assert frames[-1]["finish_reason"] == "length"
    assert all(f["finish_reason"] is None for f in frames[:-1])


def test_abort_mid_stream(frontend):
    """DELETE from a second connection ends a long-running stream with
    finish_reason="abort" — the full client-visible cancel path."""
    resp = _post(frontend.url + "/v1/generate?stream=1",
                 {"prompt": [1] * 8, "max_new_tokens": 500,
                  "request_id": "victim"})
    frames = _sse_frames(resp)
    first = next(frames)                      # stream is live
    assert first["request_id"] == "victim"

    def do_abort():
        req = urllib.request.Request(
            frontend.url + "/v1/requests/victim", method="DELETE")
        return _json(urllib.request.urlopen(req, timeout=30))

    aborter = threading.Thread(target=do_abort)
    aborter.start()
    rest = list(frames)
    aborter.join(timeout=30)
    assert rest, "stream ended without a terminal frame"
    assert rest[-1]["finish_reason"] == "abort"
    assert len(rest) < 500
    # its pages are back in the pool
    eng = frontend.llm.replicas[0]
    assert not eng.kv.has_request("victim")
    assert eng.kv.kv_free_rate == 1.0


def test_abort_unknown_request_404(frontend):
    req = urllib.request.Request(frontend.url + "/v1/requests/ghost",
                                 method="DELETE")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 404


def test_stats_snapshot(frontend):
    _json(_post(frontend.url + "/v1/generate",
                {"prompt": [1] * 16, "max_new_tokens": 6}))
    stats = _json(urllib.request.urlopen(frontend.url + "/v1/stats",
                                         timeout=30))
    assert len(stats["replicas"]) == 1
    rep = stats["replicas"][0]
    for key in ("ticks", "tokens_retired", "service_rate", "kv_free_rate",
                "waiting", "running_decode", "preemptions",
                "waiting_by_class", "prefix_lookups", "prefix_hits",
                "prefix_tokens_avoided", "bucket", "scanned_pages",
                "live_pages"):
        assert key in rep
    assert stats["tokens_retired"] >= 6
    assert rep["ticks"] > 0
    assert 0 < rep["live_pages"] <= rep["scanned_pages"]


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("body,match", [
    ({}, "prompt"),
    ({"prompt": "abc"}, "prompt"),
    ({"prompt": [True, False]}, "prompt"),   # JSON bools are not token ids
    ({"prompt": [1, 2], "typo_knob": 3}, "unknown request field"),
    ({"prompt": [1, 2], "slo_class": "platinum"}, "slo_class"),
])
def test_bad_requests_are_400(frontend, body, match):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(frontend.url + "/v1/generate", body)
    assert e.value.code == 400
    assert match in json.loads(e.value.read())["error"]


def test_unknown_endpoint_404(frontend):
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(frontend.url + "/v1/nope", timeout=30)
    assert e.value.code == 404


# ---------------------------------------------------------------------------
# OpenAI-compatible request/response surface
# ---------------------------------------------------------------------------

def test_openai_completion_shape(frontend):
    """The response body carries an OpenAI-completions shape (`id`,
    `object`, `choices`, `usage`) alongside the repo-native fields."""
    out = _json(_post(frontend.url + "/v1/generate",
                      {"prompt": [1, 2, 3, 4], "max_new_tokens": 5}))
    assert out["object"] == "completion"
    assert out["id"] == out["request_id"]
    choice = out["choices"][0]
    assert choice["index"] == 0
    assert choice["token_ids"] == out["token_ids"]
    assert choice["finish_reason"] == "length"
    assert out["usage"] == {"prompt_tokens": 4, "completion_tokens": 5,
                            "total_tokens": 9}


def test_openai_max_tokens_alias(frontend):
    out = _json(_post(frontend.url + "/v1/generate",
                      {"prompt": [1, 2, 3], "max_tokens": 4}))
    assert out["finish_reason"] == "length"
    assert len(out["token_ids"]) == 4


def test_openai_stop_alias(frontend):
    """`stop` maps onto the native token-id stop list; this prompt's
    first sampled token is deterministic (greedy), so stopping on it ends
    the request after one token with finish_reason="stop"."""
    first = _json(_post(frontend.url + "/v1/generate",
                        {"prompt": [7] * 6, "max_new_tokens": 3}))
    tok = first["token_ids"][0]
    out = _json(_post(frontend.url + "/v1/generate",
                      {"prompt": [7] * 6, "max_new_tokens": 8,
                       "stop": [tok]}))
    assert out["finish_reason"] == "stop"
    assert out["token_ids"] == [tok]


def test_openai_stream_body_flag(frontend):
    """`"stream": true` in the body is equivalent to `?stream=1`."""
    resp = _post(frontend.url + "/v1/generate",
                 {"prompt": [5, 6, 7], "max_new_tokens": 3, "stream": True})
    assert resp.headers["Content-Type"] == "text/event-stream"
    frames = list(_sse_frames(resp))
    assert frames[-1]["finish_reason"] == "length"


@pytest.mark.parametrize("body,match", [
    ({"prompt": [1], "max_tokens": 2, "max_new_tokens": 2},
     "duplicates"),
    ({"prompt": [1], "stream": "yes"}, "stream"),
])
def test_openai_alias_misuse_is_400(frontend, body, match):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(frontend.url + "/v1/generate", body)
    assert e.value.code == 400
    assert match in json.loads(e.value.read())["error"]


# ---------------------------------------------------------------------------
# spec-driven heterogeneous cluster over HTTP
# ---------------------------------------------------------------------------

def test_heterogeneous_cluster_over_http():
    """`ClusterSpec.capacities` declares an asymmetric engine pair (the JAX
    suite declares it with the simulator's `sim_overrides`); balanced
    routing sees the asymmetry through `balance_score` and the whole thing
    serves over HTTP; stats exposes both replicas."""
    spec = ServeSpec(engine=ENGINE, cluster=ClusterSpec(
        replicas=2, capacities=(1.0, ReplicaCapacity.scaled(8.0))))
    fe = HTTPFrontend(build(spec, device="cpu"), port=0).start()
    try:
        for i in range(6):
            out = _json(_post(fe.url + "/v1/generate",
                              {"prompt": [i + 1] * 24,
                               "max_new_tokens": 4}))
            assert out["finish_reason"] == "length"
        stats = _json(urllib.request.urlopen(fe.url + "/v1/stats",
                                             timeout=30))
        assert len(stats["replicas"]) == 2
        assert sum(stats["routed_counts"]) == 6
        # the declared straggler must not win the placement majority
        assert stats["routed_counts"][0] >= stats["routed_counts"][1]
    finally:
        fe.shutdown()


def test_concurrent_streams_interleave():
    """Two handler threads streaming at once: both make progress through
    the shared step lock and both terminate cleanly."""
    fe = HTTPFrontend(build(SPEC, device="cpu"), port=0).start()
    results = {}

    def one(name, n):
        resp = _post(fe.url + "/v1/generate?stream=1",
                     {"prompt": [1, 2, 3], "max_new_tokens": n})
        results[name] = list(_sse_frames(resp))

    try:
        threads = [threading.Thread(target=one, args=(f"c{i}", 3 + i))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert results["c0"][-1]["finish_reason"] == "length"
        assert results["c1"][-1]["finish_reason"] == "length"
        assert len([f for f in results["c1"] if f["token"] is not None]) == 4
    finally:
        fe.shutdown()
