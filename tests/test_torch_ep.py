"""Expert parallelism over `data` in the port (`collectives.all_to_all`,
`moe.moe_apply(ep=)`) on the CPU, against the JAX package's EP branch.

Rank processes go through `repro_torch.launch.ranks.spawn` as in
tests/test_torch_ranks.py: a ``FileStore`` under ``tmp_path``, one
intra-op thread a rank, a 60-s timeout on every collective and one on the
launch.  Each layout is launched once (a module fixture) and every rank
runs every case of it.

* The all-to-all at 2 ranks is a transpose of the chunks (numpy), in f64;
  its backward (`exchange_rows` under autograd) is the same exchange of
  the gradient; its bytes count under the ``ep`` kind.
* `moe_apply(ep=)` at dp=2 (layout (2, 1, 1)) and dp=2 x tp=2 ((2, 1, 2))
  against JAX's ``moe_apply(ep_axis="data")`` under ``jax.shard_map`` on a
  2-device host mesh (one subprocess, ``XLA_FLAGS=
  --xla_force_host_platform_device_count=2``), on the same numpy inputs:
  reduced kimi-k2 (with its shared expert) and reduced jamba, f32, at the
  config's capacity factor 1.25, with padding rows and a router skewed so
  that rows drop (asserted: outputs away from the dropless oracle).  JAX
  splits its experts' ff over `tensor` by GSPMD, which computes the same
  function, so both layouts are held to the one JAX run.  Tolerance: 2e-5
  of the output's largest magnitude (f32 products summed in another
  order); the aux loss within 1e-6.
* Dropless (capacity factor = number of experts) EP equals the port's
  NS=1 `moe_apply` and `moe_ref` on each replica's rows, within 2e-5 of
  the largest magnitude.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, make_reduced
from repro_torch.distributed import collectives as coll
from repro_torch.launch import ranks as rk
from repro_torch.launch.mesh import rank_layout
from repro_torch.models import moe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("kimi-k2-1t-a32b", "jamba-1.5-large-398b")
T = 24                      # token rows a replica
TOL = 2e-5                  # of the output's largest magnitude


def _spawn(fn, layout, job, store):
    return rk.spawn(fn, layout, (job,), store_dir=str(store), threads=1,
                    timeout_s=180, group_timeout_s=60)


def _case(arch: str, seed: int) -> dict:
    """numpy inputs of one MoE layer at dp=2: each replica's rows (a
    shared offset that the router's first two experts favour, so that
    more rows go to rank 0 than its send buffers hold), its
    padding rows, and the whole tree of router, expert and shared-expert
    weights."""
    cfg = make_reduced(get_config(arch))
    rng = np.random.default_rng(seed)
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    u = rng.normal(size=d)
    x = rng.normal(size=(2, T, d)) + u
    valid = np.ones((2, T), bool)
    valid[0, -3:] = False
    valid[1, :2] = False
    router = rng.normal(size=(d, E)) * 0.5
    router[:, :2] += 0.5 * u[:, None]    # experts 0 and 1: rank 0's, popular
    p = {"router": router,
         "w_gate": rng.normal(size=(E, d, ff)) * 0.1,
         "w_up": rng.normal(size=(E, d, ff)) * 0.1,
         "w_down": rng.normal(size=(E, ff, d)) * 0.1}
    if cfg.num_shared_experts:
        ffs = ff * cfg.num_shared_experts
        p.update(s_gate=rng.normal(size=(d, ffs)) * 0.1,
                 s_up=rng.normal(size=(d, ffs)) * 0.1,
                 s_down=rng.normal(size=(ffs, d)) * 0.1)
    return {"x": x.astype(np.float32), "valid": valid,
            "top_k": cfg.num_experts_per_tok,
            "cf": cfg.moe_capacity_factor,
            **{k: v.astype(np.float32) for k, v in p.items()}}


def _rank_params(case: dict, ranks) -> dict:
    """The rank's block: its data index's experts at its tensor index's
    ff columns, the shared expert's columns, the router whole."""
    dp, tp = ranks.size("data"), ranks.size("tensor")
    di, ti = ranks.index("data"), ranks.index("tensor")
    E, ff = case["w_gate"].shape[0], case["w_gate"].shape[-1]
    e = slice(di * E // dp, (di + 1) * E // dp)
    f = slice(ti * ff // tp, (ti + 1) * ff // tp)
    p = {"router": case["router"], "w_gate": case["w_gate"][e, :, f],
         "w_up": case["w_up"][e, :, f], "w_down": case["w_down"][e, f, :]}
    if "s_gate" in case:
        ffs = case["s_gate"].shape[-1]
        g = slice(ti * ffs // tp, (ti + 1) * ffs // tp)
        p.update(s_gate=case["s_gate"][:, g], s_up=case["s_up"][:, g],
                 s_down=case["s_down"][g, :])
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in p.items()}


def _ep_rank(ranks, job):
    """Every case on this rank: the all-to-all and its backward (at dp=2
    x tp=1), then each arch's `moe_apply(ep=)` at the config's capacity
    factor and dropless."""
    di = ranks.index("data")
    tp = ranks["tensor"] if ranks.size("tensor") > 1 else None
    out = {}
    if tp is None:
        coll.TRAFFIC.reset()
        x = torch.from_numpy(job["a2a"][di]).requires_grad_(True)
        y = coll.exchange_rows(x, ranks["data"])
        (y * torch.from_numpy(job["a2a_w"][di])).sum().backward()
        out["a2a"] = (y.detach().numpy(), x.grad.numpy(),
                      coll.TRAFFIC.bytes.get("ep", 0))
    for arch, case in job["cases"].items():
        p = _rank_params(case, ranks)
        x = torch.from_numpy(case["x"][di])
        valid = torch.from_numpy(case["valid"][di])
        E = case["w_gate"].shape[0]
        for name, cf in (("cf", case["cf"]), ("dropless", float(E))):
            y, aux = moe.moe_apply(x, p, top_k=case["top_k"],
                                   ep=ranks["data"], tp=tp,
                                   capacity_factor=cf, row_valid=valid)
            out[f"{arch}/{name}"] = (y.numpy(), float(aux))
    return out


JAX_EP = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.models.moe import moe_apply

path = sys.argv[1]
mesh = jax.make_mesh((2,), ("data",),
                     axis_types=(jax.sharding.AxisType.Auto,))
out = {}
for arch in sys.argv[2:]:
    c = dict(np.load(f"{path}/{arch}.npz"))
    top_k, cf = int(c.pop("top_k")), float(c.pop("cf"))
    x, valid = c.pop("x"), c.pop("valid")
    names = sorted(c)
    specs = [P("data") if k in ("w_gate", "w_up", "w_down") else P()
             for k in names]

    def f(x, valid, *leaves):
        p = dict(zip(names, leaves))
        y, aux = moe_apply(x[0], p, top_k=top_k, ep_axis="data",
                           capacity_factor=cf, row_valid=valid[0])
        return y[None], aux[None]

    fn = jax.shard_map(f, mesh=mesh, in_specs=(P("data"), P("data"), *specs),
                       out_specs=(P("data"), P("data")),
                       axis_names=frozenset({"data"}), check_vma=False)
    y, aux = jax.jit(fn)(jnp.asarray(x), jnp.asarray(valid),
                         *(jnp.asarray(c[k]) for k in names))
    out[arch + "/y"], out[arch + "/aux"] = np.asarray(y), np.asarray(aux)
np.savez(path + "/jax.npz", **out)
print("JAX_EP_DONE")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX run and the port's two layouts, once for the module."""
    tmp = tmp_path_factory.mktemp("ep")
    cases = {arch: _case(arch, seed) for seed, arch in enumerate(ARCHS)}
    for arch, case in cases.items():
        np.savez(tmp / f"{arch}.npz", **case)
    env = {k: v for k, v in os.environ.items() if k != "REPRO_MOE_CF"}
    env.update(PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               OMP_NUM_THREADS="1")
    jax_run = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_EP), str(tmp), *ARCHS],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    rng = np.random.default_rng(7)
    job = {"cases": cases, "a2a": rng.normal(size=(2, 6, 3)),
           "a2a_w": rng.normal(size=(2, 6, 3))}
    port = {tp: _spawn(_ep_rank, rank_layout(2, 1, tp), job, tmp / f"tp{tp}")
            for tp in (1, 2)}
    stdout, stderr = jax_run.communicate(timeout=300)
    assert jax_run.returncode == 0 and "JAX_EP_DONE" in stdout, stderr[-3000:]
    return cases, job, port, dict(np.load(tmp / "jax.npz"))


def test_all_to_all_is_a_transpose_of_chunks(runs):
    _, job, port, _ = runs
    x, w = job["a2a"], job["a2a_w"]                  # [rank, 6, 3]
    chunks = x.reshape(2, 2, 3, 3)                   # [from, to, rows, 3]
    for r, out in enumerate(port[1]):
        y, gx, nbytes = out["a2a"]
        np.testing.assert_array_equal(y, chunks[:, r].reshape(6, 3))
        # the gradient of the chunk rank r sent to rank j is the weight
        # rank j put on it
        want = w.reshape(2, 2, 3, 3)[:, r].reshape(6, 3)
        np.testing.assert_array_equal(gx, want)
        assert nbytes == 2 * x[r].nbytes             # forward and backward


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_ep_moe_matches_jax_with_drops(runs, arch, tp):
    cases, _, port, jx = runs
    case = cases[arch]
    want, aux = jx[f"{arch}/y"], jx[f"{arch}/aux"]
    scale = np.abs(want).max()
    for r in range(2):
        for t in range(tp):
            y, a = port[tp][r * tp + t][f"{arch}/cf"]
            np.testing.assert_allclose(y, want[r], rtol=0, atol=TOL * scale)
            assert abs(a - float(aux[r])) <= 1e-6
    # rows really dropped: the capped output is away from the dropless one
    p = {k: torch.from_numpy(v) for k, v in case.items()
         if k not in ("x", "valid", "top_k", "cf")}
    dense = np.stack([moe.moe_ref(torch.from_numpy(case["x"][r]), p,
                                  top_k=case["top_k"]).numpy()
                      for r in range(2)])
    live = case["valid"]
    gap = np.abs(want - dense).max(axis=-1)[live]
    assert (gap > 100 * TOL * scale).sum() >= 2, gap


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_dropless_ep_equals_one_rank(runs, arch, tp):
    cases, _, port, _ = runs
    case = cases[arch]
    E = case["w_gate"].shape[0]
    p = {k: torch.from_numpy(v) for k, v in case.items()
         if k not in ("x", "valid", "top_k", "cf")}
    for r in range(2):
        x = torch.from_numpy(case["x"][r])
        valid = torch.from_numpy(case["valid"][r])
        one, _ = moe.moe_apply(x, p, top_k=case["top_k"],
                               capacity_factor=float(E), row_valid=valid)
        ref = moe.moe_ref(x, p, top_k=case["top_k"]).numpy()
        scale = np.abs(ref).max()
        for t in range(tp):
            y, _ = port[tp][r * tp + t][f"{arch}/dropless"]
            np.testing.assert_allclose(y, one.numpy(), rtol=0,
                                       atol=TOL * scale)
            live = case["valid"][r]
            np.testing.assert_allclose(y[live], ref[live], rtol=0,
                                       atol=TOL * scale)
