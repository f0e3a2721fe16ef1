"""Rules of the PyTorch port that a test can hold it to: it imports nothing
of JAX or of the JAX package, its entry points run on CUDA unless asked for
the CPU, and its launcher runs end to end on the CPU."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
# chip_smoke's rank phases run the tests' rank functions, so that module is
# held to the port's rule as well
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "torch_rank_jobs.py"]


def _launcher_env() -> dict:
    """A launcher subprocess's environment: the port on the path, and one
    intra-op thread, since its tensors are tiny and other test processes
    share the cores."""
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_repro(path):
    assert path.exists()
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_port_files_found():
    names = {p.name for p in PORT_FILES}
    assert {"paged_attention.py", "moe_gemm.py", "rwkv6_scan.py",
            "mamba_scan.py", "ssm.py", "engine.py", "serve.py",
            "pipeline.py", "elastic.py", "trace.py", "simulator.py",
            "analysis.py", "optimizer.py", "collectives.py",
            "checkpoint.py", "train.py", "ssm_check.py",
            "mesh.py", "ranks.py", "chip_smoke.py",
            "torch_rank_jobs.py"} <= names


def test_engine_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from repro_torch.configs import get_config, make_reduced
    from repro_torch.core import ThrottleConfig
    from repro_torch.launch.serve import REDUCED_DIMS, build_engine
    from repro_torch.models.transformer import init_params
    from repro_torch.runtime.engine import PipelineEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = make_reduced(get_config("qwen1.5-0.5b")).with_plan(pp=1, tp=1)
    params = init_params(cfg, 0, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        PipelineEngine(cfg, REDUCED_DIMS, params,
                       ThrottleConfig(pipeline_depth=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_engine("qwen1.5-0.5b", reduced=True)
    eng = PipelineEngine(cfg, REDUCED_DIMS, params,
                         ThrottleConfig(pipeline_depth=1), device="cpu")
    assert eng.device.type == "cpu"


def test_unported_arch_and_pp_raise():
    """Every arch of the JAX registry resolves and an unknown one raises;
    a pipelined config builds its tick, which raises without the ring's
    carry; a heterogeneous pattern is pinned to its stage count (jamba's
    fold stays one stage, whisper's too)."""
    from repro_torch.configs import get_config, single_stage, stage_config
    from repro_torch.distributed.pipeline import build_serve_tick
    from repro_torch.launch.serve import FULL_DIMS

    for arch in ("qwen2-vl-7b", "kimi-k2-1t-a32b", "olmoe-1b-7b",
                 "minicpm3-4b", "qwen2.5-14b", "qwen1.5-0.5b",
                 "internlm2-1.8b", "whisper-small", "jamba-1.5-large-398b",
                 "rwkv6-3b", "qwen2.5-32b", "llama3.1-100b"):
        assert get_config(arch).name == arch
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("whisper-large")
    with pytest.raises(ValueError, match="pinned to pp=1"):
        stage_config(single_stage(get_config("whisper-small")), 4)
    cfg = get_config("qwen1.5-0.5b")
    tick = build_serve_tick(cfg, FULL_DIMS)
    with pytest.raises(ValueError, match="pp=8 needs the carry"):
        tick(None, None, {})
    with pytest.raises(ValueError, match="pinned to pp=1"):
        stage_config(single_stage(get_config("jamba-1.5-large-398b")), 8)
    one = single_stage(cfg)
    assert one.plan.pp == 1 and one.layers_per_stage == cfg.num_layers == 24
    assert one.pattern[0].repeat == 24 and one.padded_vocab == 151936
    # an interleaved pattern folds too: jamba's 9-layer stage, 8 times
    jamba = get_config("jamba-1.5-large-398b")
    one = single_stage(jamba)
    assert one.plan.pp == 1 and one.layers_per_stage == jamba.num_layers == 72
    assert [b.kind for b in one.pattern[:9]] == [b.kind
                                                 for b in jamba.pattern]


def test_train_launcher_runs_reduced_on_cpu_and_resumes(tmp_path):
    """`launch.train --device cpu` trains the reduced config; with --ckpt
    it checkpoints, and --resume restarts from the checkpoint."""
    env = _launcher_env()
    ck = str(tmp_path / "ck")
    base = [sys.executable, "-m", "repro_torch.launch.train", "--device",
            "cpu", "--steps", "3"]
    res = subprocess.run(base + ["--ckpt", ck, "--ckpt-every", "3"], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert "step    2 loss=" in res.stdout
    assert f"checkpointed to {ck}" in res.stdout
    assert (tmp_path / "ck" / "manifest.json").exists()
    res = subprocess.run(base + ["--ckpt", ck, "--resume"], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert f"resumed from {ck}" in res.stdout


@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-1.5-large-398b"])
def test_train_launcher_trains_recurrent_archs_on_cpu(arch):
    """`launch.train --arch ARCH --device cpu` trains the reduced f32
    config of an RWKV and of a Mamba arch (the train forms).  One
    intra-op thread: tiny tensors beside other test processes."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", arch, "--steps", "3"], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "step    2 loss=" in res.stdout


def test_train_launcher_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--steps", "1"])


def test_launcher_runs_reduced_on_cpu():
    env = _launcher_env()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--requests", "3", "--max-new", "4"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "3/3 requests, 12 tokens" in res.stdout


@pytest.mark.parametrize("launcher", ["serve", "profile"])
def test_launchers_run_reduced_olmoe_on_cpu(launcher):
    """--arch olmoe-1b-7b (ATTN_MOE blocks) runs end to end in both
    launchers on the CPU."""
    env = _launcher_env()
    res = subprocess.run(
        [sys.executable, "-m", f"repro_torch.launch.{launcher}", "--arch",
         "olmoe-1b-7b", "--reduced", "--device", "cpu", "--requests", "3",
         "--max-new", "3"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    if launcher == "serve":
        assert "[olmoe-1b-7b | cpu float32] 3/3 requests, 9 tokens" in \
            res.stdout
    else:
        out = json.loads([l for l in res.stdout.splitlines()
                          if l.startswith("{")][-1])
        assert out["arch"] == "olmoe-1b-7b" and out["ticks"] > 0


@pytest.mark.parametrize("launcher", ["serve", "profile"])
def test_launchers_run_reduced_rwkv_on_cpu(launcher):
    """--arch rwkv6-3b (RWKV blocks, state slots, the WKV scan's plain
    version) runs end to end in both launchers on the CPU."""
    env = _launcher_env()
    res = subprocess.run(
        [sys.executable, "-m", f"repro_torch.launch.{launcher}", "--arch",
         "rwkv6-3b", "--reduced", "--device", "cpu", "--requests", "3",
         "--max-new", "3"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    if launcher == "serve":
        assert "[rwkv6-3b | cpu float32] 3/3 requests, 9 tokens" in res.stdout
    else:
        out = json.loads([l for l in res.stdout.splitlines()
                          if l.startswith("{")][-1])
        assert out["arch"] == "rwkv6-3b" and out["ticks"] > 0


def test_profile_launcher_runs_reduced_on_cpu():
    """launch/profile.py (device time by kernel on the card) runs the same
    code on the CPU and prints one JSON line; the CPU has no device rows."""
    env = _launcher_env()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.profile", "--reduced",
         "--device", "cpu", "--requests", "2", "--max-new", "2"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads([l for l in res.stdout.splitlines()
                      if l.startswith("{")][-1])
    assert out["device"] == "cpu" and out["ticks"] > 0
    assert out["device_idle_share"] is None and out["kernels_ms"] == []


def test_profile_launcher_profiles_jamba_cut_on_cpu():
    """launch/profile.py takes --cut as launch/serve.py does: the reduced
    jamba cut to one layer of each of its three block kinds."""
    env = _launcher_env()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.profile", "--arch",
         "jamba-1.5-large-398b", "--reduced", "--device", "cpu", "--cut",
         "mamba_mlp,mamba_moe,attn_moe", "--requests", "2", "--max-new",
         "2"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads([l for l in res.stdout.splitlines()
                      if l.startswith("{")][-1])
    assert out["arch"] == "jamba-1.5-large-398b" and out["ticks"] > 0
    assert sorted(out["kinds"]) == ["attn_moe", "mamba_mlp", "mamba_moe"]


def test_mesh_module_touches_no_device_or_group():
    """Importing `launch.mesh` and building layouts needs no device and no
    process group (JAX's ``make_production_mesh`` is a function for the
    same reason)."""
    code = ("import sys; import torch.distributed as dist; "
            "from repro_torch.launch import mesh; "
            "l = mesh.derive_pipeline_mesh(mesh.make_production_mesh(), 4, 4); "
            "assert l.shape == (16, 4, 4) and not dist.is_initialized(); "
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules; "
            "print('ok')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr


def _fake_ranks(dp=1, pp=2, tp=2):
    """Rank 0's groups of a layout, with no process group behind them:
    enough for the checks that run before any collective."""
    from repro_torch.launch.mesh import AxisGroup, RankGroups, rank_layout

    lay = rank_layout(dp, pp, tp)
    return RankGroups(lay, 0, {n: AxisGroup(n, tuple(lay.line(n, 0)), 0)
                               for n in lay.names})


def test_engine_at_ranks_refuses_what_it_does_not_do():
    """At world > 1: CUDA graphs on CUDA raise `ValueError` (item 6.5),
    naming its ROADMAP item; nothing falls back to one rank.  Eager ticks
    and the CPU pass the refusal.  The serve tick's data axis builds
    (dp=2); engines built on one `RankLink` are numbered in order and share
    it, and a command after its stop raises."""
    from repro_torch.configs import get_config, make_reduced
    from repro_torch.core import ThrottleConfig
    from repro_torch.launch.serve import REDUCED_DIMS
    from repro_torch.runtime.engine import (
        PipelineEngine,
        RankBackend,
        RankLink,
        _refuse_at_ranks,
    )

    cfg = make_reduced(get_config("qwen1.5-0.5b")).with_plan(pp=2, tp=2)
    th = ThrottleConfig(pipeline_depth=2)
    ranks = _fake_ranks()
    with pytest.raises(ValueError, match="item 6.5"):
        PipelineEngine(cfg, REDUCED_DIMS, None, th, ranks=ranks)
    _refuse_at_ranks(cuda_graphs=True, device="cpu")
    _refuse_at_ranks(cuda_graphs=False, device="cuda")
    link = RankLink(ranks, "cpu")
    pair = [RankBackend(cfg, REDUCED_DIMS, None, None,
                        device=torch.device("cpu"), ranks=ranks, link=link)
            for _ in range(2)]
    assert [b.engine for b in pair] == [0, 1] and link.backends == pair
    link.stopped = True
    with pytest.raises(RuntimeError, match="stopped"):
        link.send(1)
    # the serve tick's data axis: a worker's backend at dp=2 builds, with
    # room for both replicas' tokens and both replicas' buffer blocks
    two = RankBackend(cfg, REDUCED_DIMS, None, None,
                      device=torch.device("cpu"), ranks=_fake_ranks(dp=2))
    rows = REDUCED_DIMS.Sp + REDUCED_DIMS.Sd
    assert two.replicas == 2 and two._host_tokens[0].numel() == 2 * rows
    one = RankBackend(cfg, REDUCED_DIMS, None, None,
                      device=torch.device("cpu"), ranks=_fake_ranks())
    assert two._program(REDUCED_DIMS).size == \
        2 * one._program(REDUCED_DIMS).size
    # a state move names the replica's ranks: stage by stage, tensor
    # ranks within
    assert two._holders(1) == [4, 5, 6, 7] and one._holders(0) == [0, 1, 2, 3]


def test_collectives_have_no_one_rank_guard():
    from repro_torch.distributed import collectives

    assert not hasattr(collectives, "_one_rank")
    g = torch.arange(5000, dtype=torch.float32) / 5000
    assert torch.equal(collectives.compressed_psum(g, None), g)
    assert torch.equal(collectives.compressed_psum(g, "ring8"), g)


def test_rank_launchers_default_to_cuda_and_raise_without_it(monkeypatch):
    from repro_torch.launch import serve, train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--steps", "1", "--pp", "2", "--tp", "2"])
    monkeypatch.setattr(sys, "argv", ["serve", "--reduced", "--pp", "2",
                                      "--tp", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main()
