"""Request-state migration of the recurrent kinds across ranks, on the CPU
(gloo): the reduced rwkv6-3b at tp=2 and the reduced jamba-1.5-large-398b
(MAMBA_MLP, MAMBA_MOE, ATTN_MOE) at dp=2 x tp=2 with its experts split
over `data`, each layout spawned once (`serve_rank` with a list of runs).

A request moved out of the rank engine mid-decode carries, in the
one-process engine's layout, its WKV heads (rwkv) or Mamba channels and
KV heads (jamba) gathered from every tensor rank and its shift states
whole from tensor rank 0: the same keys, shapes and dtype as the
one-process engine's export of the same request at the same progress, and
values within `STATE_TOL` (the batches it shared differ, and so does the
order of f32 sums).  Moved into a one-process engine, and a one-process
move into a fresh rank engine, each finishes with the unmigrated run's
tokens, which are JAX's dense reference's greedy tokens.  Prefix caching
stays refused for a pattern with recurrent blocks at ranks.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import SamplingParams, ThrottleConfig
from repro_torch.launch.mesh import rank_layout
from repro_torch.launch.serve import move_in, move_out
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.serve import ServeDims
from repro_torch.runtime.engine import PipelineEngine
from test_torch_hygiene import _fake_ranks
from test_torch_ranks import _spawn
from test_torch_tp_serve import DIMS, THROTTLE, cfgs, jax_greedy, jax_params
from torch_rank_jobs import serve_rank

MAX_NEW = 6
STATE_TOL = 1e-4
LAYOUTS = {"rwkv6-3b": (1, 1, 2), "jamba-1.5-large-398b": (2, 1, 2)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(cfg):
    rng = np.random.default_rng(9)
    return [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
            for n in (9, 21, 13)]


def _one(ref):
    cfg = ref["cfg"].with_plan(tp=1)
    return PipelineEngine(cfg, ServeDims(**DIMS),
                          params_from_numpy(cfg, ref["tree"]),
                          ThrottleConfig(pipeline_depth=1, **THROTTLE),
                          device="cpu")


def _moved_at(eng, prompts, rid, n_out):
    """The one-process move of `rid` once it holds `n_out` tokens (the
    rest of the batch served to the end)."""
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=MAX_NEW),
                            request_id=f"r{i}")
            for i, p in enumerate(prompts)]
    req = reqs[int(rid[1:])]
    for _ in range(400):
        if req.num_output_tokens >= n_out:
            m = move_out(eng, rid)
            if m is not None:
                eng.drain()
                return m
        eng.step()
    raise AssertionError(f"{rid} never reached {n_out} tokens out of flight")


@pytest.fixture(scope="module", params=list(LAYOUTS))
def served(request, tmp_path_factory):
    """One spawn of the arch's layout, three runs: plain; r1 moved out at
    step 4; a one-process move of r2 (at 2 tokens) resumed."""
    arch = request.param
    jcfg, cfg = cfgs(arch, 1, LAYOUTS[arch][2])
    d = tmp_path_factory.mktemp(arch)
    jparams, tree = jax_params(jcfg, d / "w.npz")
    ref = dict(arch=arch, cfg=cfg, tree=tree, prompts=_prompts(cfg))
    into = _moved_at(_one(ref), ref["prompts"], "r2", 2)
    job = dict(cfg=cfg, dims=ServeDims(**DIMS),
               throttle=ThrottleConfig(pipeline_depth=1, **THROTTLE),
               prompts=ref["prompts"], max_new=MAX_NEW, device="cpu",
               dtype="float32", npz=str(d / "w.npz"),
               runs=[{}, dict(export={"r1": 4}),
                     dict(prompts=[], imports=[into])])
    out = _spawn(serve_rank, rank_layout(*LAYOUTS[arch]), job, d, "ranks")
    runs = out[0]["runs"]
    ref["want"] = jax_greedy(jcfg, jparams, ref["prompts"],
                             runs[0]["tokens"])
    return ref, out, into


def test_unmigrated_run_gives_jax_greedy_tokens(served):
    ref, out, _ = served
    assert out[0]["runs"][0]["tokens"] == ref["want"]


def test_exported_state_equals_the_one_process_export(served):
    """Keys, shapes, dtype and values of the KV and state payloads; the
    split leaves gathered from both tensor ranks, the shift states whole."""
    ref, out, _ = served
    (moved,) = out[0]["runs"][1]["moved"]
    n = moved["request"].num_output_tokens
    assert 0 < n < MAX_NEW
    want = _moved_at(_one(ref), ref["prompts"], "r1", n)
    for got, exp in ((moved["kv"], want["kv"]),
                     (moved["state"]["slot_leaves"],
                      want["state"]["slot_leaves"])):
        assert set(got) == set(exp)
        for k in exp:
            assert got[k].shape == exp[k].shape and \
                got[k].dtype == exp[k].dtype, k
            np.testing.assert_allclose(got[k].numpy(), exp[k].numpy(),
                                       atol=STATE_TOL, rtol=STATE_TOL,
                                       err_msg=k)
    kinds = {k.rsplit("/", 1)[1] for k in want["state"]["slot_leaves"]}
    assert kinds == ({"tm_x", "cm_x", "wkv"} if ref["arch"] == "rwkv6-3b"
                     else {"conv", "ssm"})
    assert bool(moved["kv"]) == (ref["arch"] != "rwkv6-3b")
    # rank 0 took every block as `state` traffic
    assert out[0]["runs"][1]["rank_stats"]["traffic"]["bytes"]["state"] > 0


def test_moved_requests_finish_with_the_unmigrated_tokens(served):
    """Rank -> one-process, and one-process -> rank."""
    ref, out, into = served
    runs = out[0]["runs"]
    (moved,) = runs[1]["moved"]
    eng = _one(ref)
    req = move_in(eng, moved)
    eng.drain()
    assert req.output_token_ids == ref["want"][1]
    assert eng.slots.owner == {}
    assert into["request"].num_output_tokens == 2
    assert runs[2]["moved_in"] == {"r2": ref["want"][2]}


@pytest.mark.parametrize("arch", list(LAYOUTS))
def test_prefix_caching_stays_refused_for_recurrent_patterns(arch):
    _, cfg = cfgs(arch, 1, 2)
    with pytest.raises(ValueError, match="recurrent state"):
        PipelineEngine(cfg, ServeDims(**DIMS), None,
                       ThrottleConfig(pipeline_depth=1, **THROTTLE),
                       ranks=_fake_ranks(*LAYOUTS[arch]), device="cpu",
                       cuda_graphs=False, enable_prefix_caching=True)
