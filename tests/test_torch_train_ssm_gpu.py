"""RWKV and Mamba training on the card: the train forms of `models/ssm.py`
(`wkv6_train`, `selective_scan_train`) against autograd of the sequential
f32 recurrence, and a train step through them.  This file imports no JAX.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_train_ssm_gpu.py

Every test needs the card (``gpu`` marker; whether one is present is
decided in a fixture at run time, so they skip without one):

  * both forms within `ssm_check`'s bound of the sequential recurrence
    (outputs and every input's gradient) at init, strong and no decay, with
    f32 and bf16 inputs, at rwkv6-3b's head of 64 and jamba's d_state 16;
  * each planted copy of `ssm_check.PLANTS` failing that check at strong
    decay;
  * a train step of the reduced rwkv6-3b and jamba configs at widths the
    kernels take (d = 128) giving the CPU step's loss, aux and gnorm, with
    the scan kernels launched 0 times (the MoE kernel, under autograd, in
    jamba's MAMBA_MOE and ATTN_MOE layers: layers x M x 2 times).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, make_reduced
from repro_torch.distributed.optimizer import adam_init
from repro_torch.distributed.pipeline import build_train_step
from repro_torch.kernels import mamba_scan, moe_gemm, rwkv6_scan
from repro_torch.models import ssm
from repro_torch.models import ssm_check as sc
from repro_torch.models.transformer import init_params

WKV_SHAPE = (2, 300, 4, 64)       # B, T, H, D: four chunks and a partial
MAMBA_SHAPE = (2, 300, 256, 16)   # S, T, di, ds
FORMS = {"wkv": (ssm.wkv6_train, sc.sequential_wkv6, sc.wkv_case,
                 WKV_SHAPE),
         "mamba": (ssm.selective_scan_train, sc.sequential_selective_scan,
                   sc.mamba_case, MAMBA_SHAPE)}


@pytest.fixture
def cuda_device():
    """The card, decided at run time (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("decay", list(sc.WKV_DECAYS))
@pytest.mark.parametrize("form", list(FORMS))
def test_train_form_matches_sequential_on_card(cuda_device, form, decay,
                                               dtype):
    fn, seq_fn, case, shape = FORMS[form]
    inputs = case(*shape, decay, seed=11, dtype=getattr(torch, dtype),
                  device=cuda_device)
    res = sc.check(fn, seq_fn, inputs)
    assert res["out"] <= 1.0 and res["grad"] <= 1.0, res


@pytest.mark.gpu
@pytest.mark.parametrize("plant", list(sc.PLANTS))
def test_planted_forms_fail_on_card(cuda_device, plant):
    _, seq_fn, case, shape = FORMS[plant.split()[0]]
    inputs = case(*shape, "strong", seed=12, device=cuda_device)
    assert sc.check(sc.planted(plant), seq_fn, inputs)["grad"] > 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-1.5-large-398b"])
def test_train_step_on_card_matches_cpu(cuda_device, arch):
    cfg = make_reduced(get_config(arch), d_model=128, d_ff=256)
    cfg = dataclasses.replace(
        cfg.with_plan(pp=1, tp=1), dtype="float32", rwkv_head_dim=64,
        mamba_d_state=16, moe_d_ff=128 if cfg.moe_d_ff else 0)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab_size, (2, 1, 128)).astype(np.int32)
             for k in ("tokens", "labels")}
    metrics = {}
    for dev in ("cpu", cuda_device):
        params = init_params(cfg, 0, dtype=torch.float32).to(dev).trainable()
        step = build_train_step(cfg, device=dev)
        before = [m.launches for m in (rwkv6_scan, mamba_scan, moe_gemm)]
        _, _, m = step(params, adam_init(params), batch)
        metrics[str(dev)] = {k: float(v) for k, v in m.items()}
        launched = [m.launches - b for m, b in zip(
            (rwkv6_scan, mamba_scan, moe_gemm), before)]
    moe_layers = sum(bs.repeat for bs in cfg.pattern
                     if bs.kind.value.endswith("moe"))
    assert launched == [0, 0, moe_layers * 2 * 2]
    for k in ("loss", "aux", "gnorm"):
        want = metrics["cpu"][k]
        assert abs(metrics["cuda"][k] - want) <= 1e-4 * abs(want), k
