"""Data parallelism of the port (``levelgan_torch/dist/mesh.py``) on the
CPU: two gloo ranks against one process and against the JAX package's
2-device mesh, in f32 at ``tests/test_dist.py``'s tolerances.

One launch of two ranks (a file store in a temporary directory) runs the
module's jobs: ``api.train`` for two steps of four presets (the BCE step,
the WGAN-GP step with the presence prior's global spread, the tile
curriculum's ceiling, baseline and A2C denominators, the race curriculum's
baseline and drivers), one injected step of the WGAN-GP step with presence
and of the curriculum step from the JAX side's parameters and draws, the
collectives and the presence prior's gradient alone, and the replica
check of ``api.save_state``.  The CLI cases (two hosts meeting at a
localhost port against one host; SIGTERM at dp=2, resume) run in
subprocesses with one thread each, so that every rank sums in the same
order.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelgan.config import preset as j_preset
from levelgan.data.dataset import synthetic_corpus
from levelgan.dist.mesh import make_mesh, replicated_sharding
from levelgan.lio.checkpoint import load_checkpoint as j_load_checkpoint
from levelgan.ops.presence import presence_penalty as j_presence_penalty
from levelgan.train.curriculum import create_curriculum_state as j_create_cur
from levelgan.train.curriculum import make_curriculum_step as j_make_cur
from levelgan.train.gan import make_gan_step as j_make_gan
from levelgan.train.state import create_state as j_create_state
from levelgan.train.wgan_gp import make_wgan_gp_step as j_make_wgan
from jax.sharding import NamedSharding, PartitionSpec as P
from levelgan_torch import api
from levelgan_torch.config import Config, preset
from levelgan_torch.dist import mesh
from levelgan_torch.lio.checkpoint import all_checkpoints, load_checkpoint
from levelgan_torch.ops.presence import presence_penalty
from levelgan_torch.train import state as tstate
import test_torch_curriculum as tcur
import test_torch_train as ttrain
from test_torch_presence import _sample
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL, LOSS_RTOL = 5e-4, 5e-6, 2e-4     # tests/test_dist.py's
B = 8                                         # 4 a rank at dp=2
LAUNCH_S = 600   # the module launch's deadline (about 40 s of work)
TILE = {"model.base_channels": 16, "model.critic_base_channels": 16,
        "model.latent_dim": 16, "model.group_size": 8,
        "model.dtype": "float32", "train.batch_size": B,
        "data.corpus_size": 32, "train.steps": 2, "io.log_every": 1}
PRESETS = {
    "toy_dcgan_16": {},
    "wgan_gp_32_structural": {"model.level_size": 16, "train.n_critic": 2},
    "curriculum_16_joint": {"train.n_critic": 2,
                            "curriculum.rollout_steps": 8},
    "race_curriculum_32": {"model.n_segments": 16, "model.rnn_hidden": 16,
                           "model.critic_base_channels": 8,
                           "model.group_size": 4},
}
STEPS = ("wgan_presence", "curriculum_joint")     # injected from JAX


def _cfg(name, out, **kw):
    return preset(name).override(**{**TILE, **PRESETS[name],
                                    "io.out_dir": str(out), **kw})


def _arrays(path):
    with np.load(os.path.join(path, "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


def _metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as fh:
        return [json.loads(s) for s in fh.read().splitlines()]


def _state_flat(state):
    return {k: v.detach().numpy().copy()
            for k, v in api._state_tensors(state).items()}


# ---- the jobs each rank runs ----------------------------------------------

def _collectives():
    """global_sum forward and backward (twice differentiable), the
    gradient mean, shard."""
    r, n = mesh.rank(), mesh.world_size()
    x = torch.tensor([1.0 + r, 2.0 * r], requires_grad=True)
    y = mesh.global_sum(x * x)
    (g,) = torch.autograd.grad(y.sum(), x, create_graph=True)
    (gg,) = torch.autograd.grad(g.sum(), x)
    grads = mesh.all_reduce_grads([torch.full((2, 2), float(r)),
                                   torch.tensor([3.0 * r])])
    return {"y": y.detach().numpy(), "g": g.detach().numpy(),
            "gg": gg.numpy(), "mean0": grads[0].numpy(),
            "mean1": grads[1].numpy(),
            "shard": mesh.shard(torch.arange(12.).reshape(2, 6), 1).numpy(),
            "n": n}


def _presence(fake):
    """The penalty of this rank's slice and its gradient over the
    world size, with the spread over the global batch."""
    x = mesh.shard(torch.from_numpy(fake)).requires_grad_()
    pen = presence_penalty(x, w_spread=1.0, w_excess=2.0, excess_band=0.5)
    (g,) = torch.autograd.grad(pen, x)
    return {"pen": float(pen), "grad": (g / mesh.world_size()).numpy()}


def _injected_step(cfg_dict, models, step, baseline, ids, draws):
    """One step from given parameters and draws, each rank on its slice."""
    cfg = Config.from_dict(cfg_dict)
    gen_cls, critic_cls = tstate.model_classes(cfg)
    gen, critic = gen_cls(cfg.model), critic_cls(cfg.model)
    gen.load_state_dict(models["generator"])
    critic.load_state_dict(models["critic"])
    agents = None
    if "agent_strong" in models:
        agents = tuple(tstate.init_agents(cfg, 0))
        for a, k in zip(agents, ("agent_strong", "agent_weak")):
            a.load_state_dict(models[k])
    state = tstate.create_state(cfg, "cpu", generator=gen, critic=critic,
                                agents=agents)
    state.step = step
    if baseline is not None:
        state.g_baseline = torch.tensor(baseline)
    axis = 0 if cfg.train.loss == "gan" else 1     # [B, H, W] or [n, B, ..]
    with api.step_mode():
        state, met = api.make_step_fn(cfg)(
            state, mesh.shard(torch.from_numpy(ids), axis),
            noise=mesh.shard_tree(draws))
    hist = met.pop("gen_hist")
    met, hist = mesh.reduce_for_log(met, hist)
    return {"state": _state_flat(state), "hist": hist.numpy(),
            "metrics": {k: float(v) for k, v in met.items()}}


def _replica_check(out):
    """save_state after one rank's parameter moved by one ulp: refused on
    every rank."""
    cfg = _cfg("toy_dcgan_16", out)
    state = tstate.create_state(cfg, "cpu")
    if mesh.rank() == 1:
        with torch.no_grad():
            p = next(state.generator.parameters())
            p.view(-1)[0] = torch.nextafter(p.view(-1)[0],
                                            torch.tensor(2.0))
    try:
        api.save_state(str(out), state, cfg, 0, 0)
    except RuntimeError as e:
        return str(e)
    return None


def _rank_jobs(jobs):
    out = []
    for kind, args in jobs:
        if kind == "train":
            out.append(api.train(Config.from_dict(args), device="cpu",
                                 echo=False))
        else:
            out.append(globals()[kind](*args))
    return out


# ---- the JAX side ----------------------------------------------------------

def _jax_mesh2_step(jcfg, j_state, ids):
    """The JAX step on the conftest's 2-device mesh: batch sharded on
    'data' (ids [B, H, W] for the BCE step, [n_critic, B, H, W] else),
    state replicated."""
    m2 = make_mesh(2)
    step, spec = {"curriculum": (j_make_cur, P(None, "data")),
                  "gan": (j_make_gan, P("data"))}.get(
        jcfg.train.loss, (j_make_wgan, P(None, "data")))
    f = jax.jit(step(jcfg), in_shardings=(
        replicated_sharding(m2), NamedSharding(m2, spec)))
    return f(j_state, jnp.asarray(ids))


def _wgan_case(**kw):
    """The WGAN-GP step with the presence prior (and ``kw``'s overrides)
    from the JAX side's parameters and draws."""
    jcfg, _ = ttrain._cfgs()
    jcfg = jcfg.override(**{"train.w_presence": 10.0, **kw})
    j_state = j_create_state(jcfg, jax.random.key(0))
    ids = synthetic_corpus(ttrain.N_CRITIC * ttrain.B, ttrain.LEVEL,
                           seed=3).reshape(ttrain.N_CRITIC, ttrain.B,
                                           ttrain.LEVEL, ttrain.LEVEL)
    flat = {**ttrain._flat(j_state.generator, "generator"),
            **ttrain._flat(j_state.discriminator, "discriminator")}
    cfg = Config.from_dict(jcfg.to_dict())
    gen, critic = tstate.model_classes(cfg)
    models = {"generator": gen(cfg.model), "critic": critic(cfg.model)}
    from levelgan_torch.bridge import (critic_params_from_flat,
                                       generator_params_from_flat)
    models["generator"].load_state_dict(generator_params_from_flat(flat))
    models["critic"].load_state_dict(critic_params_from_flat(flat))
    return (jcfg, j_state, ids, ttrain._jax_draws(jcfg, j_state),
            {k: v.state_dict() for k, v in models.items()}, 0, None)


def _curriculum_case():
    name, kw, port_kw = tcur.CASES["joint_fused"]
    jcfg = j_preset(name).override(**tcur.TINY, **kw)
    j_state = j_create_cur(jcfg, jax.random.key(0)).replace(
        step=jnp.int32(tcur.START_STEP),
        g_baseline=jnp.float32(tcur.BASELINE))
    ids = np.random.default_rng(3).integers(
        0, 8, size=(tcur.N_CRITIC, tcur.B, tcur.LEVEL, tcur.LEVEL)).astype(
            np.uint8)
    cfg = Config.from_dict(jcfg.to_dict())
    st = tcur.port_state_from(cfg, j_state)
    models = {"generator": st.generator.state_dict(),
              "critic": st.critic.state_dict(),
              "agent_strong": st.agent_strong.state_dict(),
              "agent_weak": st.agent_weak.state_dict()}
    return (jcfg, j_state, ids, tcur.jax_draws(jcfg, j_state), models,
            tcur.START_STEP, tcur.BASELINE)


# ---- the module's one launch ----------------------------------------------

@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp2")
    cases = {"wgan_presence": _wgan_case(),
             "curriculum_joint": _curriculum_case()}
    fake = _sample("collapsed", seed=9)
    jobs = [("train", _cfg(n, root / n).to_dict()) for n in PRESETS]
    jobs += [("_injected_step", (Config.from_dict(jcfg.to_dict()).to_dict(),
                                 models, step, base, ids, draws))
             for jcfg, _, ids, draws, models, step, base in cases.values()]
    jobs += [("_collectives", ()), ("_presence", (fake,)),
             ("_replica_check", (str(root / "replica"),))]
    plan = mesh.Plan(world=2, local=2, first_rank=0, device_type="cpu")
    ranks = mesh.launch(_rank_jobs, (jobs,), {}, plan, timeout=LAUNCH_S)
    res = {"root": root, "fake": fake, "cases": cases, "ranks": ranks}
    names = list(PRESETS) + list(STEPS) + ["collectives", "presence",
                                           "replica"]
    res.update({n: [r[i] for r in ranks] for i, n in enumerate(names)})
    return res


# ---- (a) dp=2 against the port's dp=1 --------------------------------------

@pytest.mark.parametrize("name", list(PRESETS))
def test_dp2_run_equals_the_single_process_run(dp2, tmp_path, name):
    """Two steps through ``api.train``: the checkpoint's every array (the
    parameters, the EMA, the Adam moments, the baseline) and each step's
    d_loss.  The run's own replica check held the ranks' states bit-equal
    at the checkpoint."""
    one = api.train(_cfg(name, tmp_path), device="cpu", echo=False)
    got = check_dp2_run(one, tmp_path, dp2[name], dp2["root"] / name)
    if "curriculum" in name:
        assert float(got["g_baseline"]) != 0.0


def check_dp2_run(one, one_out, two, two_out):
    """``api.train``'s two-step dp=2 run (both ranks' results, its out
    dir) against the single-process run; returns the dp=2 checkpoint's
    arrays."""
    assert [r["rank"] for r in two] == [0, 1]
    assert two[0]["checkpoint"] == two[1]["checkpoint"]
    want, got = _arrays(one["checkpoint"]), _arrays(two[0]["checkpoint"])
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    lines1, lines2 = _metrics(one_out), _metrics(two_out)
    assert [r["step"] for r in lines2] == [1, 2]
    for a, b in zip(lines1, lines2):
        np.testing.assert_allclose(b["d_loss"], a["d_loss"], rtol=LOSS_RTOL)
    # every rank's metrics were reduced to the same record
    host = ("wall_time", "step_ms")
    assert ({k: v for k, v in two[0]["metrics"].items() if k not in host}
            == {k: v for k, v in two[1]["metrics"].items() if k not in host})
    return got


# ---- (b) dp=2 against the JAX package's 2-device mesh ----------------------

@pytest.mark.parametrize("case", STEPS)
def test_dp2_step_equals_the_jax_mesh2_step(dp2, case):
    """One injected step at dp=2 against the JAX step on ``make_mesh(2)``:
    the ranks bit-equal, the metrics at rtol 1e-4 (the histogram exactly),
    the parameters and the EMA after their Adam update at
    ``tests/test_dist.py``'s tolerances."""
    jcfg, j_state, ids, _, _, _, _ = dp2["cases"][case]
    check_mesh2_step(dp2[case], jcfg, j_state, ids)


def check_mesh2_step(ranks, jcfg, j_state, ids):
    """Two ranks' ``_injected_step`` results against the JAX step on
    ``make_mesh(2)``."""
    j_new, j_met = _jax_mesh2_step(jcfg, j_state, ids)
    r0, r1 = ranks
    for k, v in r0["state"].items():
        np.testing.assert_array_equal(r1["state"][k], v, err_msg=k)
    assert r0["metrics"] == r1["metrics"]
    np.testing.assert_array_equal(r0["hist"], np.asarray(j_met["gen_hist"]))
    for k in set(r0["metrics"]) - {"tau"}:
        np.testing.assert_allclose(r0["metrics"][k], float(j_met[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    want = {"generator": j_new.generator, "critic": j_new.discriminator,
            "g_ema": j_new.g_ema}
    if jcfg.train.loss == "curriculum":
        want.update(agent_strong=j_new.agent_strong,
                    agent_weak=j_new.agent_weak)
        np.testing.assert_allclose(r0["state"]["g_baseline"],
                                   float(j_new.g_baseline), rtol=1e-5)
    for field, tree in want.items():
        for k, v in ttrain._flat(tree, field).items():
            name = field + "." + k.split("/", 1)[1].replace("/", ".")
            np.testing.assert_allclose(r0["state"][name], v, rtol=RTOL,
                                       atol=ATOL, err_msg=name)


def test_presence_spread_is_global_and_its_gradient_is_the_whole_batchs(
        dp2):
    """The penalty of a collapsed batch (the spread hinge engaged): the
    ranks' mean is the whole batch's (the JAX package's value), and each
    rank's gradient over the world size is its slice of the whole batch's
    gradient: global_sum's summed backward under the averaged
    gradients."""
    fake = dp2["fake"]
    want, want_g = jax.value_and_grad(lambda f: j_presence_penalty(
        f, w_spread=1.0, w_excess=2.0, excess_band=0.5))(jnp.asarray(fake))
    r0, r1 = dp2["presence"]
    np.testing.assert_allclose((r0["pen"] + r1["pen"]) / 2, float(want),
                               rtol=1e-5)
    np.testing.assert_allclose(np.concatenate([r0["grad"], r1["grad"]]),
                               np.asarray(want_g), rtol=1e-5, atol=1e-8)
    # a local spread would see each half's own placements
    local = presence_penalty(torch.from_numpy(fake[:3]), w_spread=1.0,
                             w_excess=2.0, excess_band=0.5)
    assert float(local) != pytest.approx(r0["pen"], rel=1e-6)


def test_collectives_sum_mean_and_shard(dp2):
    for r, got in enumerate(dp2["collectives"]):
        assert got["n"] == 2
        # y = x0^2 + x1^2 over the ranks' x = [1 + r, 2r]
        np.testing.assert_array_equal(got["y"], [1.0 + 4.0, 0.0 + 4.0])
        # d(sum y)/dx on each rank: 2 ranks' cotangents summed, 2 * 2x
        np.testing.assert_array_equal(got["g"], 4 * np.array([1.0 + r,
                                                              2.0 * r]))
        np.testing.assert_array_equal(got["gg"], [4.0, 4.0])
        np.testing.assert_array_equal(got["mean0"], np.full((2, 2), 0.5))
        np.testing.assert_array_equal(got["mean1"], [1.5])
        np.testing.assert_array_equal(
            got["shard"], np.arange(12.).reshape(2, 6)[:, 3 * r:3 * r + 3])


def test_save_state_refuses_ranks_that_differ(dp2):
    for msg in dp2["replica"]:
        assert msg and "different states" in msg and "generator." in msg
    assert not os.path.exists(dp2["root"] / "replica" / "step_00000000")


# ---- (c)-(e) the CLI: two hosts, SIGTERM, resume ---------------------------

def _cli(out, *sets, steps=2):
    args = [sys.executable, "-m", "levelgan_torch.cli.train", "--device",
            "cpu", "--preset", "toy_dcgan_16", "--out", str(out)]
    for k, v in {**TILE, "train.steps": steps}.items():
        args += ["--set", f"{k}={v}"]
    for kv in sets:
        args += ["--set", kv]
    return args


def _popen(args):
    return subprocess.Popen(args, cwd=REPO, env={**os.environ,
                                                 "OMP_NUM_THREADS": "1"},
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _done(proc, timeout=120):
    try:
        text = proc.communicate(timeout=timeout)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, text
    return text


def test_launch_kills_its_ranks_and_raises_at_its_deadline():
    """Two ranks that sleep past a 5 s deadline: both are killed and the
    launch raises ``TimeoutError`` naming them, in seconds, not at the end
    of their sleep."""
    plan = mesh.Plan(world=2, local=2, first_rank=0, device_type="cpu")
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"ranks \[0, 1\]"):
        mesh.launch(time.sleep, (120,), {}, plan, timeout=5)
    assert time.monotonic() - t0 < 15


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_hosts_equal_one_host(tmp_path):
    """Two processes meeting at ``localhost:<port>`` (dist.num_processes
    2, process_id 0 / 1, one rank each) write the checkpoint that one
    process with two ranks writes, bit for bit; only rank 0 prints the
    summary."""
    addr = f"localhost:{_free_port()}"
    one = _popen(_cli(tmp_path / "one", "dist.dp=2"))
    hosts = [_popen(_cli(tmp_path / "two", "dist.dp=2",
                         f"dist.coordinator_address={addr}",
                         "dist.num_processes=2", f"dist.process_id={i}"))
             for i in range(2)]
    texts = [_done(p) for p in (one, *hosts)]
    assert "done: checkpoint=" in texts[1]
    assert "done: checkpoint=" not in texts[2]
    want = _arrays(all_checkpoints(str(tmp_path / "one" / "ckpt"))[-1])
    got = _arrays(all_checkpoints(str(tmp_path / "two" / "ckpt"))[-1])
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_sigterm_at_dp2_then_resume_equals_an_uninterrupted_run(tmp_path):
    """SIGTERM to the CLI's launching process after its first logged step:
    both ranks stop after the same step, one checkpoint, exit 0; resumed
    with ``--resume auto`` at dp=2 it equals an uninterrupted dp=2 run bit
    for bit, and its checkpoint loads in one process of either package."""
    whole = _popen(_cli(tmp_path / "whole", "dist.dp=2", steps=40))
    out = tmp_path / "split"
    proc = _popen(_cli(out, "dist.dp=2", steps=40))
    metrics = out / "metrics.jsonl"
    deadline = time.monotonic() + 90
    try:
        while not (metrics.exists() and metrics.stat().st_size):
            assert proc.poll() is None, proc.communicate()[0]
            assert time.monotonic() < deadline, "no step logged in 90 s"
            time.sleep(0.01)
        proc.send_signal(signal.SIGTERM)
    finally:
        text = _done(proc)
    assert "preempted: checkpoint=" in text
    stopped = all_checkpoints(str(out / "ckpt"))
    assert len(stopped) == 1
    stop_step = int(_arrays(stopped[0])["step"])
    assert 1 <= stop_step < 40
    _done(_popen(_cli(out, "dist.dp=2", steps=40) + ["--resume", "auto"]))
    _done(whole)
    want = _arrays(all_checkpoints(str(tmp_path / "whole" / "ckpt"))[-1])
    final = all_checkpoints(str(out / "ckpt"))[-1]
    got = _arrays(final)
    assert int(got["step"]) == 40
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert [r["step"] for r in _metrics(out)] == list(range(1, 41))

    # the dp=2 checkpoint in one process: the port's and the JAX package's
    cfg = preset("toy_dcgan_16").override(**TILE)
    state = load_checkpoint(final, tstate.create_state(cfg, "cpu"))[0]
    assert state.step == 40
    for k, v in state.generator.state_dict().items():
        np.testing.assert_array_equal(
            v.numpy(), got["generator/" + k.replace(".", "/")], err_msg=k)
    from levelgan.config import Config as JConfig
    j_cfg = JConfig.from_dict(cfg.to_dict())
    j_state = j_load_checkpoint(final, j_create_state(j_cfg,
                                                      jax.random.key(0)))[0]
    assert int(j_state.step) == 40
    for k, v in ttrain._flat(j_state.generator, "generator").items():
        np.testing.assert_array_equal(v, got[k], err_msg=k)


# ---- (f) refusals -----------------------------------------------------------

@pytest.mark.parametrize("dist,match", [
    ({"dist.dp": 2, "train.batch_size": 3}, "not divisible by mesh"),
    ({"dist.dp": 4096}, "only"),
    ({"dist.num_processes": 2}, "coordinator_address"),
    ({"dist.num_processes": 2, "dist.coordinator_address": "localhost:1",
      "dist.process_id": 0, "dist.dp": 3},
     "not divisible by dist.num_processes"),
    ({"dist.num_processes": 2, "dist.coordinator_address": "localhost:1",
      "dist.process_id": 2}, "outside"),
], ids=["batch", "dp_over_mesh", "hosts_without_address", "dp_over_hosts",
        "process_id"])
def test_train_refuses_a_mesh_it_cannot_build(tmp_path, dist, match):
    with pytest.raises(ValueError, match=match):
        api.train(_cfg("toy_dcgan_16", tmp_path, **dist), device="cpu",
                  echo=False)


def test_process_id_from_the_launchers_environment(monkeypatch):
    cfg = _cfg("toy_dcgan_16", "unused", **{
        "dist.num_processes": 2, "dist.coordinator_address": "h:1",
        "dist.dp": 2})
    for k in ("GROUP_RANK", "NODE_RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="set dist.process_id"):
        mesh.make_plan(cfg.dist, "cpu")
    monkeypatch.setenv("NODE_RANK", "1")
    plan = mesh.make_plan(cfg.dist, "cpu")
    assert (plan.world, plan.local, plan.first_rank,
            plan.init_method) == (2, 1, 1, "tcp://h:1")


def test_mesh_sizes_and_the_helpers_outside_a_group():
    assert mesh.mesh_size(0, 8) == 8 and mesh.mesh_size(2, 8) == 2
    with pytest.raises(ValueError):
        mesh.mesh_size(16, 8)
    x = torch.arange(6.)
    assert mesh.global_sum(x) is x and mesh.shard(x) is x
    assert mesh.global_mean(x) == x.mean()
    grads = [torch.ones(2)]
    assert mesh.all_reduce_grads(grads)[0] is grads[0]
    assert mesh.any_rank(True) and not mesh.any_rank(False)
    # dp=0 is one rank on the CPU: no launch
    plan = mesh.make_plan(preset("toy_dcgan_16").dist, "cpu")
    assert (plan.world, plan.local) == (1, 1)


def test_a_process_a_launcher_started_joins_its_group(tmp_path,
                                                      monkeypatch):
    """torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR /
    PORT): ``api.train`` joins that group, here of one rank, instead of
    launching, and trains as that rank."""
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                 "MASTER_ADDR": "localhost",
                 "MASTER_PORT": str(_free_port())}.items():
        monkeypatch.setenv(k, v)
    try:
        with pytest.raises(ValueError, match="mesh has 1 ranks"):
            api.train(_cfg("toy_dcgan_16", tmp_path, **{"dist.dp": 2}),
                      device="cpu", echo=False)
        res = api.train(_cfg("toy_dcgan_16", tmp_path), device="cpu",
                        echo=False)
        assert mesh.active() and mesh.world_size() == 1
    finally:
        if mesh.active():
            torch.distributed.destroy_process_group()
    assert res["rank"] == 0 and not res["preempted"]
    assert int(_arrays(res["checkpoint"])["step"]) == 2
