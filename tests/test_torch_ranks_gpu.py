"""The port across ranks on the card: 2 and 4 processes sharing the one
H100 under gloo (`repro_torch.launch.ranks.spawn`).  Every test carries the
``gpu`` marker and skips without a card; this file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_ranks_gpu.py

qwen1.5-0.5b at its published width (16:16 heads of 64, d_ff 2,816) cut to
4 layers, f32, at small serve dims:
  * served over pp=2 x tp=2 and pp=2 x tp=1 ranks: the tokens and the batch
    of every tick of the single-process pp=2 engine on the same weights
    (drawn from the seed, each rank its block), and paged attention
    launched on every rank once per layer of its stage for each phase a
    tick runs (the counts are each rank's own);
  * trained over (1, 2, 2) ranks at lr 0: the loss of the dense
    cross-entropy within 2e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import BlockSpec, get_config, single_stage, stage_config
from repro_torch.core import SamplingParams, ThrottleConfig
from repro_torch.data.tokens import batches
from repro_torch.launch import ranks as rk
from repro_torch.launch.mesh import rank_layout
from repro_torch.launch.train import train_rank
from repro_torch.models.reference import dense_forward
from repro_torch.models.serve import ServeDims
from repro_torch.models.transformer import cross_entropy, init_params
from repro_torch.runtime.engine import PipelineEngine
from torch_rank_jobs import serve_rank

DIMS = ServeDims(Sp=1, C=32, Sd=8, pages=64, page=16, Bp=8, Bd=8, slots=16)
LAYERS = 4


@pytest.fixture
def cuda_device():
    """The card, decided at run time (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    return torch.device("cuda")


def _cfg(pp: int, tp: int):
    cfg = single_stage(get_config("qwen1.5-0.5b"))
    cfg = dataclasses.replace(cfg, num_layers=LAYERS, dtype="float32",
                              pattern=(BlockSpec(cfg.pattern[0].kind,
                                                 LAYERS),))
    return stage_config(cfg, pp).with_plan(tp=tp)


def _spawn(fn, layout, job, tmp_path):
    return rk.spawn(fn, layout, (job,), backend="gloo",
                    store_dir=str(tmp_path / "store"), threads=1,
                    timeout_s=300, group_timeout_s=300)


@pytest.mark.gpu
@pytest.mark.parametrize("tp", [2, 1])
def test_serve_ranks_match_one_process(cuda_device, tmp_path, tp):
    cfg = _cfg(2, tp)
    one = cfg.with_plan(tp=1)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in (5, 40, 17, 70)]
    throttle = ThrottleConfig(pipeline_depth=2)
    params = init_params(one, 0, dtype=torch.float32, device=cuda_device)
    eng = PipelineEngine(one, DIMS, params, throttle, device=cuda_device,
                         cuda_graphs=False)
    ticks = []
    inner = eng.backend.execute

    def execute(ring, exiting_id, now):
        b = (eng.scheduler.get_batch(ring[0][0])
             if ring[0][0] is not None else None)
        ticks.append(None if b is None else [
            [[q.request.request_id, q.start_pos, q.num_tokens]
             for q in b.prefill],
            [q.request.request_id for q in b.decode]])
        return inner(ring, exiting_id, now)

    eng.backend.execute = execute
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=6),
                            request_id=f"r{i}") for i, p in enumerate(prompts)]
    eng.drain(max_ticks=2000)
    want = [r.output_token_ids for r in reqs]
    del eng, params
    torch.cuda.empty_cache()
    job = dict(cfg=cfg, dims=DIMS, throttle=throttle, prompts=prompts,
               max_new=6, device="cuda", dtype="float32", seed=0)
    out = _spawn(serve_rank, rank_layout(1, 2, tp), job, tmp_path)
    assert out[0]["tokens"] == want
    assert out[0]["ticks"] == ticks
    st = out[0]["stats"]
    phases = st["prefill_ticks"] + st["decode_ticks"]
    for o in out:
        assert o["launches"]["paged_attention"] == \
            phases * cfg.layers_per_stage, o["rank"]


@pytest.mark.gpu
def test_train_ranks_lr0_loss_matches_dense(cuda_device, tmp_path):
    cfg = _cfg(1, 1)
    batch = next(batches(cfg.vocab_size, 2, 1, 256, seed=0))
    params = init_params(cfg, 0, dtype=torch.float32, device=cuda_device)
    toks, labs = (torch.as_tensor(batch[k], device=cuda_device)
                  .reshape(2, 256).long() for k in ("tokens", "labels"))
    want = float(cross_entropy(dense_forward(cfg, params, toks), labs))
    del params
    torch.cuda.empty_cache()
    job = dict(cfg=_cfg(2, 2), steps=1, batches=[batch], lr=0.0,
               aux_coef=0.0, device="cuda", dtype="float32", seed=0)
    out = _spawn(train_rank, rank_layout(1, 2, 2), job, tmp_path)
    assert {o["loss"][0] for o in out} == {out[0]["loss"][0]}
    assert abs(out[0]["loss"][0] - want) < 2e-4
