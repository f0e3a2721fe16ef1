"""The port's checkpoints (`repro_torch.runtime.checkpoint`) against the JAX
package's: the same on-disk layout, so that each package restores the
other's, f32 and bf16, bit for bit; the async writer's snapshot; elastic
restore across pipeline factorings; and the engine's checkpoint/restart
(a twin of tests/test_checkpoint.py::test_engine_snapshot_restore)."""

import dataclasses
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jax_get_config
from repro.configs import make_reduced as jax_make_reduced
from repro.distributed.optimizer import adam_init as jax_adam_init
from repro.models import transformer as jax_tfm
from repro.runtime import checkpoint as jax_ckpt
from repro_torch.configs import BlockSpec, get_config, make_reduced
from repro_torch.core import SamplingParams, ThrottleConfig
from repro_torch.distributed.elastic import elastic_restore, replan
from repro_torch.distributed.optimizer import adam_init
from repro_torch.models.serve import ServeDims
from repro_torch.models.transformer import (
    TransformerParams,
    abstract_params,
    init_params,
    tree_items,
)
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime.engine import PipelineEngine

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch: str = "olmoe-1b-7b"):
    jc = jax_make_reduced(jax_get_config(arch))
    return jc, make_reduced(get_config(arch))


def _bits(a) -> np.ndarray:
    """A leaf's bytes as integers (bf16 compares bit for bit)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy().view(np.int32 if a.element_size() == 4 else np.int8)
    a = np.asarray(a)
    return a.view({2: np.int16, 4: np.int32}[a.dtype.itemsize])


def _flat_jax(tree) -> dict:
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_jax_checkpoint_restores_into_the_port(tmp_path, dtype):
    tdt, jdt = DTYPES[dtype]
    jc, tc = _cfgs()
    params = jax_tfm.init_params(jc, jax.random.key(0), dtype=jdt)
    jax_ckpt.save_checkpoint(str(tmp_path), params, extra={"step": 3})
    got = ckpt.restore_checkpoint(str(tmp_path), abstract_params(tc, tdt))
    assert isinstance(got, TransformerParams)
    want = _flat_jax(params)
    flat = dict(tree_items(got))
    assert set(flat) == set(want)
    for key, t in flat.items():
        assert t.dtype == tdt and t.device.type == "cpu"
        np.testing.assert_array_equal(_bits(t), _bits(want[key]))
    assert ckpt.load_manifest(str(tmp_path))["extra"] == {"step": 3}


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_port_checkpoint_restores_into_jax(tmp_path, dtype):
    tdt, jdt = DTYPES[dtype]
    jc, tc = _cfgs()
    params = init_params(tc, 1, dtype=tdt)
    ckpt.save_checkpoint(str(tmp_path), params)
    target = jax_tfm.init_params(jc, jax.random.key(0), dtype=jdt)
    got = _flat_jax(jax_ckpt.restore_checkpoint(str(tmp_path), target))
    flat = dict(tree_items(params))
    assert set(flat) == set(got)
    for key, arr in got.items():
        assert np.asarray(arr).dtype == np.asarray(_flat_jax(target)[key]).dtype
        np.testing.assert_array_equal(_bits(arr), _bits(flat[key]))


def test_adam_state_has_the_jax_layout(tmp_path):
    """An `AdamState` saves under JAX's paths (step, m/..., v/...) and
    restores into a fresh state bit for bit."""
    jc, tc = _cfgs("qwen1.5-0.5b")
    jax_ckpt.save_checkpoint(str(tmp_path / "jax"), jax_adam_init(
        jax_tfm.init_params(jc, jax.random.key(0), dtype=jnp.float32)))
    opt = adam_init(init_params(tc, 0, dtype=torch.float32))
    for _, t in tree_items(opt.m):
        t.normal_()
    ckpt.save_checkpoint(str(tmp_path / "port"), opt)
    jax_keys = ckpt.load_manifest(str(tmp_path / "jax"))["leaves"]
    port_keys = ckpt.load_manifest(str(tmp_path / "port"))["leaves"]
    assert jax_keys == port_keys
    got = ckpt.restore_checkpoint(str(tmp_path / "port"), opt)
    assert type(got) is type(opt) and int(got.step) == 0
    for (k, a), (_, b) in zip(tree_items(got.m), tree_items(opt.m)):
        assert torch.equal(a, b), k


def test_async_checkpointer_writes_the_tree_as_submitted(tmp_path,
                                                         monkeypatch):
    """`submit` snapshots a copy: an in-place update after it (the next
    Adam step) does not reach the file the writer thread is writing."""
    release = threading.Event()
    save = ckpt.save_checkpoint

    def held_save(*args, **kwargs):
        release.wait(30)
        return save(*args, **kwargs)

    monkeypatch.setattr(ckpt, "save_checkpoint", held_save)
    tree = {"w": torch.full((8, 8), 3.0),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}
    ck = ckpt.AsyncCheckpointer()
    ck.submit(str(tmp_path / "s0"), tree, extra={"step": 0})
    tree["w"].add_(1.0)
    tree["b"]["c"].mul_(2.0)
    release.set()
    ck.wait()
    ck.close()
    got = ckpt.restore_checkpoint(str(tmp_path / "s0"), tree)
    assert torch.equal(got["w"], torch.full((8, 8), 3.0))
    assert torch.equal(got["b"]["c"], torch.ones(4, dtype=torch.bfloat16))


def test_restore_refuses_missing_leaves_and_other_shapes(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), {"a": torch.zeros(3)})
    with pytest.raises(KeyError, match="missing leaf 'b'"):
        ckpt.restore_checkpoint(str(tmp_path), {"b": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_checkpoint(str(tmp_path), {"a": torch.zeros(4)})


def test_elastic_restore_from_pp2_to_pp1(tmp_path):
    """A checkpoint of 4 layers saved at pp=2 (2 a stage) restores at pp=1
    (4 in one stage): the same logical layers, on the device and in the
    dtype asked for."""
    _, tc = _cfgs("qwen1.5-0.5b")
    cfg2 = dataclasses.replace(
        tc, num_layers=4, pattern=(BlockSpec(tc.pattern[0].kind, 2),))
    assert cfg2.plan.pp == 2
    params = init_params(cfg2, 0, dtype=torch.float32)
    ckpt.save_checkpoint(str(tmp_path), params)
    cfg1 = replan(cfg2, 1, 1)
    got = elastic_restore(str(tmp_path), cfg2, cfg1, device="cpu",
                          dtype=torch.bfloat16)
    for (k, a), (_, b) in zip(tree_items(got), tree_items(params)):
        assert a.dtype == torch.bfloat16
        if k.startswith("stages/"):
            assert a.shape[:2] == (1, 4)
        assert torch.equal(a, b.reshape(a.shape).to(torch.bfloat16)), k


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "whisper-small"])
def test_engine_snapshot_restore(arch):
    """Engine restart resumes unfinished requests by recompute and keeps
    the prefix they had emitted (an encoder-decoder's request keeps its
    encoder input); the restarted run emits what the first engine does."""
    _, tc = _cfgs(arch)
    cfg = dataclasses.replace(tc.with_plan(pp=1, tp=1), dtype="float32")
    dims = ServeDims(Sp=1, C=16, Sd=8, pages=256, page=8, Bp=32, Bd=32,
                     slots=16, Te=16 if cfg.is_encoder_decoder else 0)
    th = ThrottleConfig(pipeline_depth=1, max_prefill_tokens=16,
                        min_prefill_tokens=4, num_iters_T=2)
    params = init_params(cfg, 0, dtype=torch.float32)
    eng = PipelineEngine(cfg, dims, params, th, device="cpu")
    rng = np.random.default_rng(0)
    prompt = [int(t) for t in rng.integers(0, cfg.vocab_size, 20)]
    enc = (rng.normal(size=(16, cfg.d_model)) * 0.5).astype(np.float32)
    r = eng.add_request(prompt, SamplingParams(max_new_tokens=8),
                        enc_embeds=enc)
    for _ in range(6):
        eng.step()
    snap = eng.snapshot_state()
    partial = list(r.output_token_ids)
    assert 0 < len(partial) < 8
    assert snap["requests"][0]["output"] == partial

    eng2 = PipelineEngine(cfg, dims, params, th, device="cpu")
    PipelineEngine.restore_requests(eng2, snap)
    if cfg.is_encoder_decoder:
        assert torch.equal(eng2.enc_embeds[r.request_id],
                           torch.from_numpy(enc))
    eng2.drain(max_ticks=300)
    r2 = [q for q in eng2.finished if q.request_id == r.request_id][0]
    assert r2.is_finished
    assert r2.output_token_ids[:len(partial)] == partial
    assert len(r2.output_token_ids) == 8
    eng.drain(max_ticks=300)
    assert r.output_token_ids == r2.output_token_ids
