"""The rank engine's state in and out on the card: 4 processes sharing
the one H100 under gloo.  Every test carries the ``gpu`` marker and skips
without a card; this file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_ranks_state_gpu.py

qwen1.5-0.5b at its published width cut to 4 layers, f32, at pp=2 x tp=2:
  * a request moved out of the rank engine mid-decode carries the
    one-process pp=2 engine's payload (same keys, shapes, dtype; values
    within f32 rounding) and finishes there with the unmigrated tokens; a
    one-process move finishes in a fresh rank engine; prefix-cached and
    async runs give the sync tokens;
  * a checkpoint saved at (1, 2, 2) ranks is the one-process save of the
    same weights byte for byte, and restores at every rank its block.
"""

import filecmp
import os

import numpy as np
import pytest
import torch

from repro_torch.core import SamplingParams, ThrottleConfig
from repro_torch.launch.mesh import rank_layout
from repro_torch.launch.serve import move_in, move_out
from repro_torch.launch.train import train_rank
from repro_torch.models.transformer import (
    TransformerParams,
    abstract_params,
    init_params,
    param_pspecs,
    shard_params,
    tree_items,
    tree_map,
)
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime.engine import PipelineEngine
from test_torch_ranks_gpu import DIMS, _cfg, _spawn
from torch_rank_jobs import serve_rank

MAX_NEW = 8
F32_TOL = 1e-4


@pytest.fixture
def cuda_device():
    """The card, decided at run time (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    return torch.device("cuda")


def _one(cfg, dev, **kw):
    one = cfg.with_plan(tp=1)
    params = init_params(one, 0, dtype=torch.float32, device=dev)
    return PipelineEngine(one, DIMS, params, ThrottleConfig(pipeline_depth=2),
                          device=dev, cuda_graphs=False, **kw)


def _moved_at(eng, prompts, rid, n_out):
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=MAX_NEW),
                            request_id=f"r{i}")
            for i, p in enumerate(prompts)]
    req = reqs[int(rid[1:])]
    for _ in range(400):
        if req.num_output_tokens >= n_out:
            m = move_out(eng, rid)
            if m is not None:
                eng.drain()
                return m, [r.output_token_ids for r in reqs]
        eng.step()
    raise AssertionError(f"{rid} never reached {n_out} tokens out of flight")


@pytest.mark.gpu
def test_state_moves_between_rank_and_one_process_engines(cuda_device,
                                                          tmp_path):
    cfg = _cfg(2, 2)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in (5, 40, 17)]
    shared = prompts[1][:32]
    pre = [shared + [1, 2, 3], shared + [4, 5]]
    into, _ = _moved_at(_one(cfg, cuda_device), prompts, "r2", 3)
    job = dict(cfg=cfg, dims=DIMS, throttle=ThrottleConfig(pipeline_depth=2),
               prompts=prompts, max_new=MAX_NEW, device="cuda",
               dtype="float32", seed=0,
               runs=[{}, dict(export={"r1": 12}),
                     dict(prompts=[], imports=[into]),
                     dict(async_dispatch=True),
                     dict(prompts=pre, arrive=[0, 12],
                          enable_prefix_caching=True)])
    out = _spawn(serve_rank, rank_layout(1, 2, 2), job, tmp_path)
    runs = out[0]["runs"]
    plain = runs[0]["tokens"]
    assert runs[3]["tokens"] == plain
    assert runs[4]["prefix"]["hits"] >= 1
    (moved,) = runs[1]["moved"]
    n = moved["request"].num_output_tokens
    assert 0 < n < MAX_NEW
    want, _ = _moved_at(_one(cfg, cuda_device), prompts, "r1", n)
    assert set(moved["kv"]) == set(want["kv"])
    for k, v in want["kv"].items():
        assert moved["kv"][k].shape == v.shape and \
            moved["kv"][k].dtype == v.dtype
        np.testing.assert_allclose(moved["kv"][k].numpy(), v.numpy(),
                                   atol=F32_TOL, rtol=F32_TOL)
    eng = _one(cfg, cuda_device)
    req = move_in(eng, moved)
    eng.drain()
    assert req.output_token_ids == plain[1]
    assert runs[2]["moved_in"] == {"r2": plain[2]}


@pytest.mark.gpu
def test_checkpoint_round_trip_at_ranks(cuda_device, tmp_path):
    cfg = _cfg(2, 2)
    job = dict(cfg=cfg, steps=1, seq=64, M=2, mbg=1, lr=0.0, device="cuda",
               dtype="float32", ckpt=str(tmp_path / "ranks"))
    _spawn(train_rank, rank_layout(1, 2, 2), job, tmp_path)
    one = cfg.with_plan(tp=1)
    whole = TransformerParams(tree_map(
        torch.Tensor.cpu, init_params(one, 0, dtype=torch.float32,
                                      device=cuda_device)))
    ckpt.save_checkpoint(str(tmp_path / "one"), whole, extra={"step": 0})
    names = sorted(os.listdir(tmp_path / "one"))
    assert sorted(os.listdir(tmp_path / "ranks")) == names
    for name in names:
        assert filecmp.cmp(tmp_path / "ranks" / name, tmp_path / "one" / name,
                           shallow=False), name
    lay = rank_layout(1, 2, 2)
    for r in range(lay.world):
        got = ckpt.restore_checkpoint(str(tmp_path / "ranks"),
                                      abstract_params(cfg), layout=lay,
                                      rank=r, specs=param_pspecs(cfg),
                                      device=cuda_device)
        want = dict(tree_items(shard_params(cfg, whole, lay, r)))
        for k, t in tree_items(got):
            assert torch.equal(t.cpu(), want[k]), (r, k)
