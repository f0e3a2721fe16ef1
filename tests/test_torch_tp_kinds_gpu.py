"""Tensor parallelism of every block kind but ATTN_MLP across ranks on the
card: 2 or 4 processes sharing the one H100 under gloo
(`repro_torch.launch.ranks.spawn`).  Every test carries the ``gpu`` marker
and skips without a card; this file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_tp_kinds_gpu.py

Each arch's reduced config widened to the kernels' tiles (heads of 64,
d_model 256, ff 512: a rank's MoE ff is a multiple of 128 at tp=4, RWKV's
heads are of 64, Mamba's state 16 wide), f32, served over tp ranks: the
ranks' greedy tokens equal the one-process engine's on the same weights
(drawn from the seed, each rank its block) up to the dense reference's
first near-tie (top-2 gap < 1e-3), the batch of every tick equal, and
every rank launches each kernel once per layer of its kind for each phase
a tick runs (the MoE kernel once per MoE layer a tick).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import BlockSpec, get_config, make_reduced
from repro_torch.core import SamplingParams, ThrottleConfig
from repro_torch.launch import ranks as rk
from repro_torch.launch.mesh import rank_layout
from repro_torch.launch.serve import enc_inputs
from repro_torch.models.reference import greedy_trace
from repro_torch.models.serve import ServeDims
from repro_torch.models.transformer import init_params
from repro_torch.runtime.engine import PipelineEngine
from torch_rank_jobs import serve_rank

NEAR_TIE = 1e-3
MAX_NEW = 6
# a rank's launches by kernel module, and the layer kinds each runs on
KERNEL_KINDS = {"paged_attention": ("attn_mlp", "attn_moe", "dec_layer"),
                "rwkv6_scan": ("rwkv",),
                "mamba_scan": ("mamba_mlp", "mamba_moe")}


@pytest.fixture
def cuda_device():
    """The card, decided at run time (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    return torch.device("cuda")


def _cfg(arch: str):
    """`arch` reduced at the kernels' widths, one stage, f32, dropless;
    a uniform pattern two layers deep."""
    cfg = make_reduced(get_config(arch), d_model=256, d_ff=512, vocab=512)
    kv = min(cfg.num_kv_heads, 4)
    cfg = dataclasses.replace(
        cfg, head_dim=64, num_heads=4, num_kv_heads=kv, rwkv_head_dim=64,
        mamba_d_state=16, moe_d_ff=512 if cfg.is_moe else 0, dtype="float32",
        moe_capacity_factor=float(max(cfg.num_experts, 1)))
    if len(cfg.pattern) == 1:
        cfg = dataclasses.replace(
            cfg, num_layers=2, pattern=(BlockSpec(cfg.pattern[0].kind, 2),))
    else:
        cfg = dataclasses.replace(cfg, num_layers=len(cfg.pattern))
    return cfg.with_plan(pp=1, tp=1, ep_over_data=False)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,tp", [
    ("olmoe-1b-7b", 4), ("kimi-k2-1t-a32b", 2), ("minicpm3-4b", 2),
    ("rwkv6-3b", 2), ("jamba-1.5-large-398b", 2), ("whisper-small", 4)])
def test_tensor_ranks_serve_one_process_tokens(cuda_device, tmp_path, arch,
                                               tp):
    one = _cfg(arch)
    dims = ServeDims(Sp=1, C=32, Sd=8, pages=64, page=16, Bp=8, Bd=8,
                     slots=16, Te=16 if one.is_encoder_decoder else 0)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, one.vocab_size, n)]
               for n in (5, 40, 17, 70)]
    encs = [enc_inputs(one, dims, rng).get("enc_embeds") for _ in prompts]
    throttle = ThrottleConfig(pipeline_depth=1)
    params = init_params(one, 0, dtype=torch.float32, device=cuda_device)
    eng = PipelineEngine(one, dims, params, throttle, device=cuda_device,
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
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=MAX_NEW),
                            request_id=f"r{i}",
                            **({} if e is None else {"enc_embeds": e}))
            for i, (p, e) in enumerate(zip(prompts, encs))]
    eng.drain(max_ticks=2000)
    want = [r.output_token_ids for r in reqs]
    gaps = [greedy_trace(one, params, p, MAX_NEW, e)[1]
            for p, e in zip(prompts, encs)]
    del eng, params
    torch.cuda.empty_cache()
    job = dict(cfg=one.with_plan(tp=tp), dims=dims, throttle=throttle,
               prompts=prompts, encs=encs if one.is_encoder_decoder
               else None, max_new=MAX_NEW, device="cuda", dtype="float32",
               seed=0)
    out = rk.spawn(serve_rank, rank_layout(1, 1, tp), (job,),
                   backend="gloo", store_dir=str(tmp_path / "store"),
                   threads=1, timeout_s=300, group_timeout_s=300)
    for got, mine, g in zip(out[0]["tokens"], want, gaps):
        stop = next((k for k, x in enumerate(g) if x < NEAR_TIE), MAX_NEW)
        assert got[:stop] == mine[:stop]
    assert out[0]["ticks"] == ticks
    st = out[0]["stats"]
    phases = st["prefill_ticks"] + st["decode_ticks"]
    kinds = [b.kind.value for b in one.pattern for _ in range(b.repeat)]
    for o in out:
        for mod, on in KERNEL_KINDS.items():
            n = sum(k in on for k in kinds)
            assert o["launches"][mod] == phases * n, (o["rank"], mod)
        assert o["launches"]["moe_gemm"] == st["ticks"] * sum(
            k.endswith("_moe") for k in kinds), o["rank"]
