"""``model.critic_mbstd`` under data parallelism on the CPU: two gloo ranks
against one process and against the JAX package's 2-device mesh.

The critic's minibatch-stddev channel ('trunk': one scalar over the last
trunk features; 'input': a per-position map over the input) is a statistic
of the global batch under data parallelism (``mesh.global_var``: two
``global_sum`` all-reduces), and the gradient penalty's input gradient and
its double backward carry it across the ranks.  One launch of two ranks
runs the module's jobs: ``global_var`` in float64 with its gradient and
the gradient of that gradient's norm, and both by central differences
that the ranks take together; the critic's input gradient, the plain and
the K2 core GP and their averaged parameter gradients; one injected
WGAN-GP step (with the presence prior) and one BCE step with R1 from the
JAX side's parameters and draws; and ``api.train`` for two steps of every
tile step family with mbstd on.  The tolerances are
``tests/test_torch_dist.py``'s.
"""

import jax
import numpy as np
import pytest
import torch

from levelgan.data.dataset import synthetic_corpus
from levelgan.train.state import create_state as j_create_state
from levelgan_torch import api
from levelgan_torch.bridge import (critic_params_from_flat,
                                   generator_params_from_flat)
from levelgan_torch.config import Config, preset
from levelgan_torch.dist import mesh
from levelgan_torch.kernels.gp_penalty import gradient_penalty_core
from levelgan_torch.models import Critic, Generator
from levelgan_torch.ops.grad_penalty import gradient_penalty, interpolate
import test_torch_gan_step as tgan
import test_torch_train as ttrain
from test_torch_dist import (LAUNCH_S, TILE, _injected_step, _wgan_case,
                             check_dp2_run, check_mesh2_step)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

MODES = ("trunk", "input")
GPS = {"xla": gradient_penalty, "core": gradient_penalty_core}
B = 8                                  # global batch, 4 a rank
VAR_SHAPE = (6, 3, 2)                  # global_var's global batch [6, 3, 2]
FD_STEP = 1e-6                         # central differences in float64
CRITIC_RTOL, CRITIC_ATOL = 1e-5, 1e-7  # f32 sums in another order
# dp=2 runs of two steps: (preset, overrides) on TILE's small widths
RUNS = {
    "wgan_gp_32_pair": ("wgan_gp_32", {
        "model.level_size": 16, "train.n_critic": 2,
        "train.w_presence": 10.0, "model.critic_mbstd": "input"}),
    "wgan_gp_32_trunk_xla": ("wgan_gp_32", {
        "model.level_size": 16, "train.n_critic": 2,
        "model.critic_mbstd": "trunk", "model.pallas_gp": "xla"}),
    "toy_dcgan_16_r1_trunk": ("toy_dcgan_16", {
        "train.r1_gamma": 0.5, "model.critic_mbstd": "trunk"}),
    "toy_dcgan_16_r1_input": ("toy_dcgan_16", {
        "train.r1_gamma": 0.5, "model.critic_mbstd": "input"}),
    "conditional_32_input": ("conditional_32", {
        "model.level_size": 16, "train.n_critic": 2,
        "model.critic_mbstd": "input"}),
    "curriculum_16_trunk": ("curriculum_16", {
        "train.n_critic": 2, "curriculum.rollout_steps": 8,
        "model.critic_mbstd": "trunk"}),
}
STEPS = [(mode, kind) for mode in MODES for kind in ("wgan_gp", "gan_r1")]


def _run_cfg(name, out):
    base, kw = RUNS[name]
    return preset(base).override(**{**TILE, **kw, "io.out_dir": str(out)})


def _critic_cfg(mode):
    return preset("wgan_gp_32").override(**{
        **TILE, "model.level_size": 16, "model.critic_mbstd": mode})


# ---- the jobs each rank runs ----------------------------------------------

def _global_var(x, w):
    """``global_var`` of this rank's slice of ``x`` (float64); the gradient
    of <w, var> over the world size (so that the ranks' objectives sum to
    the global one); the gradient of the squared norm of that gradient;
    the collectives of each; and both gradients of the global batch by
    central differences, each element moved by the rank that holds it
    while every rank evaluates."""
    n, k = mesh.world_size(), x.shape[0] // mesh.world_size()
    wt = torch.from_numpy(w)
    xl = mesh.shard(torch.from_numpy(x)).requires_grad_()
    counts = []
    mesh.collectives.clear()
    v = mesh.global_var(xl)
    counts.append(mesh.collectives["global_sum"])
    (g,) = torch.autograd.grad((wt * v).sum() / n, xl, create_graph=True)
    counts.append(mesh.collectives["global_sum"])
    (gg,) = torch.autograd.grad(g.square().sum(), xl)
    counts.append(mesh.collectives["global_sum"])

    def objective(xv):           # <w, var>, the same on every rank
        return float((wt * mesh.global_var(xv)).sum())

    def sq_norm(xv):             # |d<w, var>/dx|^2 over the global batch
        xv = xv.clone().requires_grad_()
        (gv,) = torch.autograd.grad((wt * mesh.global_var(xv)).sum() / n,
                                    xv)
        return float(mesh.global_sum(gv.square().sum()))

    num_g, num_gg = np.zeros(x.shape), np.zeros(x.shape)
    for idx in np.ndindex(*x.shape):
        owner, row = divmod(idx[0], k)
        for sign in (1.0, -1.0):
            xv = xl.detach().clone()
            if owner == mesh.rank():
                xv[(row,) + idx[1:]] += sign * FD_STEP
            num_g[idx] += sign * objective(xv) / (2 * FD_STEP)
            num_gg[idx] += sign * sq_norm(xv) / (2 * FD_STEP)
    return {"v": v.detach().numpy(), "g": g.detach().numpy(),
            "gg": gg.numpy(), "num_g": num_g, "num_gg": num_gg,
            "counts": counts}


def _critic_gp(cfg_dict, params, real, fake, eps, gp):
    """On this rank's slice: the scores, the input gradient of their sum,
    the GP ``gp`` and its parameter gradients averaged over the ranks, and
    the collectives issued by each part."""
    cfg = Config.from_dict(cfg_dict)
    critic = Critic(cfg.model)
    critic.load_state_dict(params)
    r, f, e = (mesh.shard(torch.from_numpy(a)) for a in (real, fake, eps))
    counts = {}
    mesh.collectives.clear()
    x_hat = interpolate(r, f, e).requires_grad_()
    scores = critic(x_hat)
    counts["forward"] = mesh.collectives["global_sum"]
    (g,) = torch.autograd.grad(scores.sum(), x_hat)
    counts["input_grad"] = mesh.collectives["global_sum"] - counts["forward"]
    mesh.collectives.clear()
    with api.step_mode():
        pen = GPS[gp](critic, r, f, None, e)
        counts["gp"] = mesh.collectives["global_sum"]
        names = [k for k, _ in critic.named_parameters()]
        grads = torch.autograd.grad(pen, list(critic.parameters()),
                                    materialize_grads=True)
    counts["gp_backward"] = mesh.collectives["global_sum"] - counts["gp"]
    grads = mesh.all_reduce_grads(grads)
    counts["all_reduce_grads"] = mesh.collectives["all_reduce_grads"]
    return {"scores": scores.detach().numpy(), "g": g.numpy(),
            "gp": float(pen), "counts": counts,
            "grads": {k: v.numpy() for k, v in zip(names, grads)}}


def _rank_jobs(jobs):
    out = []
    for kind, args in jobs:
        if kind == "train":
            out.append(api.train(Config.from_dict(args), device="cpu",
                                 echo=False))
        else:
            out.append(globals()[kind](*args))
    return out


# ---- the cases --------------------------------------------------------------

def _gan_r1_case(mode):
    """The BCE step with R1 and mbstd from the JAX side's parameters and
    draws (``tests/test_torch_gan_step.py``'s small config)."""
    jcfg = tgan._jcfg(**{"train.r1_gamma": 0.5, "model.critic_mbstd": mode})
    j_state = j_create_state(jcfg, jax.random.key(0))
    ids = synthetic_corpus(tgan.B, tgan.LEVEL, seed=3)
    flat = {**ttrain._flat(j_state.generator, "generator"),
            **ttrain._flat(j_state.discriminator, "discriminator")}
    cfg = Config.from_dict(jcfg.to_dict())
    gen, critic = Generator(cfg.model), Critic(cfg.model)
    gen.load_state_dict(generator_params_from_flat(flat))
    critic.load_state_dict(critic_params_from_flat(flat))
    models = {"generator": gen.state_dict(), "critic": critic.state_dict()}
    return (jcfg, j_state, ids, tgan._jax_gan_draws(jcfg, j_state), models,
            0, None)


def _step_case(mode, kind):
    if kind == "wgan_gp":
        return _wgan_case(**{"model.critic_mbstd": mode})
    return _gan_r1_case(mode)


def _critic_inputs(seed=5):
    rng = np.random.default_rng(seed)
    eye = np.eye(8, dtype=np.float32)
    real = eye[rng.integers(0, 8, size=(B, 16, 16))]
    logits = rng.standard_normal((B, 16, 16, 8)).astype(np.float32) * 2
    fake = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    eps = rng.random((B, 1, 1, 1), dtype=np.float32)
    return real, fake, eps


def _critic_params(mode):
    critic = Critic(_critic_cfg(mode).model).init_params(
        torch.Generator().manual_seed(11))
    return {k: v.detach().clone() for k, v in critic.state_dict().items()}


# ---- the module's one launch ----------------------------------------------

@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp2_mbstd")
    rng = np.random.default_rng(7)
    x = rng.standard_normal(VAR_SHAPE)
    w = rng.standard_normal(VAR_SHAPE[1:])
    steps = {c: _step_case(*c) for c in STEPS}
    real, fake, eps = _critic_inputs()
    params = {m: _critic_params(m) for m in MODES}
    critics = [(m, gp) for m in MODES for gp in GPS]
    jobs = [("_global_var", (x, w))]
    jobs += [("_critic_gp", (_critic_cfg(m).to_dict(), params[m], real, fake,
                             eps, gp)) for m, gp in critics]
    jobs += [("_injected_step", (Config.from_dict(jcfg.to_dict()).to_dict(),
                                 models, step, base, ids, draws))
             for jcfg, _, ids, draws, models, step, base in steps.values()]
    jobs += [("train", _run_cfg(n, root / n).to_dict()) for n in RUNS]
    plan = mesh.Plan(world=2, local=2, first_rank=0, device_type="cpu")
    ranks = mesh.launch(_rank_jobs, (jobs,), {}, plan, timeout=LAUNCH_S)
    names = ["global_var"] + critics + STEPS + list(RUNS)
    res = {n: [r[i] for r in ranks] for i, n in enumerate(names)}
    res.update(root=root, x=x, w=w, steps=steps, params=params,
               inputs=(real, fake, eps))
    return res


# ---- global_var ---------------------------------------------------------------

def _one_process_var(x, w):
    """var, d<w, var>/dx and d|d<w, var>/dx|^2/dx of the whole batch."""
    xt = torch.from_numpy(x).requires_grad_()
    v = xt.var(dim=0, unbiased=False)
    (g,) = torch.autograd.grad((torch.from_numpy(w) * v).sum(), xt,
                               create_graph=True)
    (gg,) = torch.autograd.grad(g.square().sum(), xt)
    return v.detach().numpy(), g.detach().numpy(), gg.numpy()


def test_global_var_is_the_whole_batchs_var_with_its_gradients(dp2):
    """Each rank's value is the concatenated batch's population variance;
    the ranks' gradients, concatenated, are the whole batch's gradient and
    the gradient of its squared norm (float64)."""
    v, g, gg = _one_process_var(dp2["x"], dp2["w"])
    r0, r1 = dp2["global_var"]
    for r in (r0, r1):
        np.testing.assert_allclose(r["v"], v, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(np.concatenate([r0["g"], r1["g"]]), g,
                               rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(np.concatenate([r0["gg"], r1["gg"]]), gg,
                               rtol=1e-10, atol=1e-14)


def test_global_var_gradients_match_central_differences(dp2):
    """gradcheck's rule across the ranks: both analytic gradients against
    central differences of the global function (float64, step 1e-6)."""
    r0, r1 = dp2["global_var"]
    for r in (r0, r1):     # every rank took the same differences
        np.testing.assert_array_equal(r["num_g"], r0["num_g"])
        np.testing.assert_array_equal(r["num_gg"], r0["num_gg"])
    np.testing.assert_allclose(np.concatenate([r0["g"], r1["g"]]),
                               r0["num_g"], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.concatenate([r0["gg"], r1["gg"]]),
                               r0["num_gg"], rtol=1e-5, atol=1e-7)


def test_global_var_issues_two_all_reduces_and_their_twins(dp2):
    """Two all-reduces forward (the mean, the squared deviations), two in
    the backward (their cotangents), two more in the double backward; the
    same on every rank, so the ranks' collectives pair up."""
    for r in dp2["global_var"]:
        assert r["counts"] == [2, 4, 6]


def test_global_var_outside_a_group_is_torch_var():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (5, 4, 3)).astype(np.float32))
    assert not mesh.active()
    assert torch.equal(mesh.global_var(x), x.var(dim=0, unbiased=False))


# ---- the critic and the GP ------------------------------------------------------

@pytest.mark.parametrize("gp", list(GPS))
@pytest.mark.parametrize("mode", MODES)
def test_critic_gp_at_dp2_equals_the_whole_batchs(dp2, mode, gp):
    """The scores and the input gradient of their sum (the cross-sample
    terms from the other rank's samples included), the GP (the ranks'
    mean) and its parameter gradients after ``all_reduce_grads``, against
    the critic on the whole batch in one process; the ranks bit-equal
    where they share a value."""
    real, fake, eps = dp2["inputs"]
    critic = Critic(_critic_cfg(mode).model)
    critic.load_state_dict(dp2["params"][mode])
    x_hat = interpolate(*map(torch.from_numpy, (real, fake, eps)))
    x_hat.requires_grad_(True)
    scores = critic(x_hat)
    (g,) = torch.autograd.grad(scores.sum(), x_hat)
    with api.step_mode():
        pen = GPS[gp](critic, *map(torch.from_numpy, (real, fake)), None,
                      torch.from_numpy(eps))
        grads = torch.autograd.grad(pen, list(critic.parameters()),
                                    materialize_grads=True)
    r0, r1 = dp2[(mode, gp)]
    got = {k: np.concatenate([r0[k], r1[k]]) for k in ("scores", "g")}
    np.testing.assert_allclose(got["scores"], scores.detach().numpy(),
                               rtol=CRITIC_RTOL, atol=CRITIC_ATOL)
    np.testing.assert_allclose(got["g"], g.numpy(), rtol=CRITIC_RTOL,
                               atol=CRITIC_ATOL)
    np.testing.assert_allclose((r0["gp"] + r1["gp"]) / 2, pen.item(),
                               rtol=CRITIC_RTOL)
    for (name, _), want in zip(critic.named_parameters(), grads):
        np.testing.assert_array_equal(r1["grads"][name], r0["grads"][name])
        np.testing.assert_allclose(r0["grads"][name], want.numpy(),
                                   rtol=CRITIC_RTOL, atol=CRITIC_ATOL,
                                   err_msg=name)
    # a rank's own samples alone would give another statistic
    local = Critic(_critic_cfg(mode).model)
    local.load_state_dict(dp2["params"][mode])
    alone = local(x_hat[:B // 2].detach())
    assert not np.allclose(alone.detach().numpy(), r0["scores"],
                           rtol=1e-3, atol=0)
    # every rank issued the same collectives: 2 a critic forward, 2 in the
    # input gradient's backward
    assert r0["counts"] == r1["counts"]
    assert r0["counts"]["forward"] == r0["counts"]["input_grad"] == 2
    assert r0["counts"]["gp"] == 4 and r0["counts"]["gp_backward"] >= 2
    assert r0["counts"]["all_reduce_grads"] == 1


# ---- one injected step against the JAX package's 2-device mesh -------------------

@pytest.mark.parametrize("mode,kind", STEPS,
                         ids=[f"{m}-{k}" for m, k in STEPS])
def test_dp2_mbstd_step_equals_the_jax_mesh2_step(dp2, mode, kind):
    """One injected step at dp=2 against the JAX step on ``make_mesh(2)``
    (its critic's ``var(axis=0)`` over the sharded global batch): the
    ranks bit-equal, the metrics at rtol 1e-4 (the histogram exactly),
    the parameters and the EMA after their Adam update at
    ``tests/test_dist.py``'s tolerances."""
    jcfg, j_state, ids, _, _, _, _ = dp2["steps"][(mode, kind)]
    check_mesh2_step(dp2[(mode, kind)], jcfg, j_state, ids)


# ---- api.train at dp=2 against one process ------------------------------------

@pytest.mark.parametrize("name", list(RUNS))
def test_dp2_mbstd_run_equals_the_single_process_run(dp2, tmp_path, name):
    """Two steps through ``api.train`` with mbstd on, dp=2 against one
    process on the same global batch: every checkpoint array and each
    step's d_loss, the ranks' records equal."""
    one = api.train(_run_cfg(name, tmp_path), device="cpu", echo=False)
    got = check_dp2_run(one, tmp_path, dp2[name], dp2["root"] / name)
    if "curriculum" in name:
        assert float(got["g_baseline"]) != 0.0
