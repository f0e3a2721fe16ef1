"""The serving stack over ranks on the card: a spec served by
`build(spec, ranks=)` over pp=2 x tp=2 (4 processes sharing the one H100
under gloo, eager ticks) against the one-process pp=2 engine of the same
spec, and one request streamed through `HTTPFrontend` on rank 0.  Every
test carries the ``gpu`` marker and skips without a card; this file imports
no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_ranks_serving_gpu.py

qwen1.5-0.5b at its published width cut to 4 layers (`build(layers=)`),
f32, random weights from the spec's seed (each rank draws its shard of the
same tree).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import SamplingParams
from repro_torch.launch.mesh import rank_layout
from repro_torch.serving import EngineSpec, ServeSpec, build
from test_torch_ranks_gpu import DIMS, _spawn
from torch_rank_jobs import serving_rank

LAYERS = 4
MAX_NEW = 8


@pytest.fixture
def cuda_device():
    """The card, decided at run time (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_spec_served_over_ranks_matches_one_process(cuda_device, tmp_path):
    dims = {k: getattr(DIMS, k) for k in ("Sp", "C", "Sd", "pages", "page",
                                          "Bp", "Bd", "slots")}
    spec = ServeSpec(engine=EngineSpec(arch="qwen1.5-0.5b", reduced=False,
                                       dims=dims))
    one = build(spec, device=cuda_device, dtype=torch.float32,
                layers=LAYERS, pp=2, cuda_graphs=False)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, one.cfg.vocab_size, n)]
               for n in (9, 40, 23, 70)]
    rids = [one.submit(p, SamplingParams(max_new_tokens=MAX_NEW),
                       request_id=f"r{i}") for i, p in enumerate(prompts)]
    one.drain()
    want = [o.token_ids for o in one.outputs(rids)]
    one.close()
    del one
    torch.cuda.empty_cache()
    job = dict(device="cuda", dtype="float32", layers=LAYERS,
               prompts=prompts, max_new=MAX_NEW,
               runs=[dict(spec=spec.to_json(), do="stream")])
    out = _spawn(serving_rank, rank_layout(1, 2, 2), job, tmp_path)
    run = out[0]["runs"][0]
    assert run["tokens"] == want
    assert run["http_stream"] == want[0] and run["stream_end"] == "length"
    assert all(st["ticks"] > 0 for o in out[1:] for st in o["runs"][0])
