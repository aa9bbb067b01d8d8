"""Resume, graceful stop and NaN checks of the port's trainer, on the CPU.

A run stopped after 2 steps and resumed for 2 more equals an
uninterrupted 4-step run bit for bit, for both losses (the stop is
requested in-process, where the SIGTERM handler would set it); a JAX
checkpoint resumes in the port with its Adam moments, counts and step, and
a port checkpoint resumes in ``levelgan.api.train``; ``io.resume='auto'``
walks back past a truncated checkpoint and refuses when none loads; the
train CLI in a subprocess exits 0 on SIGTERM with a checkpoint that
``--resume auto`` continues.  Every run is a few steps at a tiny width.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelgan.api import train as j_train
from levelgan.config import Config as JConfig
from levelgan.data.dataset import synthetic_corpus
from levelgan.lio.checkpoint import save_checkpoint as j_save_checkpoint
from levelgan.train.state import create_state as j_create_state
from levelgan.train.wgan_gp import make_wgan_gp_step as j_make_wgan_gp_step
from levelgan_torch import api
from levelgan_torch.cli import train as cli_train
from levelgan_torch.config import preset
from levelgan_torch.lio.checkpoint import all_checkpoints, load_checkpoint
from levelgan_torch.train import state as tstate
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"model.level_size": 16, "model.base_channels": 16,
        "model.critic_base_channels": 16, "model.group_size": 8,
        "model.latent_dim": 8, "model.dtype": "float32",
        "train.batch_size": 4, "train.n_critic": 2, "data.corpus_size": 16,
        "io.log_every": 1, "io.compile_cache": ""}
PRESETS = {"gan": "toy_dcgan_16", "wgan_gp": "gumbel_64"}
METRICS = {"gan": ("d_loss", "g_loss", "d_real", "d_fake", "kl"),
           "wgan_gp": ("d_loss", "g_loss", "gp", "wdist", "kl")}


def _cfg(loss, out, **kw):
    return preset(PRESETS[loss]).override(
        **{**TINY, "io.out_dir": str(out), **kw})


def _arrays(path):
    with np.load(os.path.join(path, "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


def _metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as fh:
        return [json.loads(s) for s in fh.read().splitlines()]


def _stop_after(monkeypatch, steps):
    """Replace the signal handlers by a stop request that is raised while
    step ``steps - 1`` runs, as a SIGTERM landing then would."""
    stops = []

    class Stop:
        def __init__(self):
            self.requested = False
            stops.append(self)

        def restore(self):
            pass

    step_generator = api.step_generator

    def spy(cfg, step, device):
        if step == steps - 1:
            stops[-1].requested = True
        return step_generator(cfg, step, device)

    monkeypatch.setattr(api, "_StopRequest", Stop)
    monkeypatch.setattr(api, "step_generator", spy)


@pytest.mark.parametrize("loss", ["gan", "wgan_gp"])
def test_stopped_and_resumed_run_equals_an_uninterrupted_one(
        tmp_path, monkeypatch, loss):
    kw = {"train.steps": 4, "train.lr_schedule": "cosine",
          "io.ckpt_every": 3}
    whole = api.train(_cfg(loss, tmp_path / "whole", **kw), device="cpu",
                      echo=False)
    assert not whole["preempted"]

    with monkeypatch.context() as mp:
        _stop_after(mp, 2)
        first = api.train(_cfg(loss, tmp_path / "split", **kw), device="cpu",
                          echo=False)
    assert first["preempted"]
    assert first["checkpoint"].endswith("step_00000002")
    second = api.train(_cfg(loss, tmp_path / "split", **kw,
                            **{"io.resume": "auto"}), device="cpu",
                       echo=False)
    assert not second["preempted"]

    want, got = _arrays(whole["checkpoint"]), _arrays(second["checkpoint"])
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # the resumed run appends; its steps log as the whole run's do
    lines = _metrics(tmp_path / "split")
    assert [r["step"] for r in lines] == [1, 2, 3, 4]
    for a, b in zip(lines, _metrics(tmp_path / "whole")):
        for k in METRICS[loss]:
            assert a[k] == b[k], (a["step"], k)
    # the cadence held across the stop: step 3's checkpoint (ckpt_every=3)
    assert [os.path.basename(p) for p in all_checkpoints(
        str(tmp_path / "split" / "ckpt"))] == [
            "step_00000002", "step_00000003", "step_00000004"]


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    cfg = _cfg("wgan_gp", tmp_path, **{"train.lr_schedule": "cosine",
                                       "train.steps": 10})
    jcfg = JConfig.from_dict(cfg.to_dict())
    j_state = j_create_state(jcfg, jax.random.key(0))
    step = jax.jit(j_make_wgan_gp_step(jcfg))
    ids = synthetic_corpus(2 * 2 * 4, 16, seed=4).reshape(2, 2, 4, 16, 16)
    for i in range(2):
        j_state, _ = step(j_state, jnp.asarray(ids[i]))
    path = j_save_checkpoint(str(tmp_path / "ckpt"), j_state, jcfg)

    state = tstate.create_state(cfg, "cpu", seed=9)
    state, rcfg = load_checkpoint(path, state)
    assert rcfg == cfg and state.step == 2
    want = _arrays(path)
    for opt, model, prefix in ((state.opt_g, state.generator, "opt_g"),
                               (state.opt_d, state.critic, "opt_d")):
        assert opt.count == int(want[f"{prefix}/0/count"]) > 0
        for name, p in model.named_parameters():
            key = name.replace(".", "/")
            np.testing.assert_array_equal(opt.state[p]["exp_avg"].numpy(),
                                          want[f"{prefix}/0/mu/{key}"])
            np.testing.assert_array_equal(opt.state[p]["exp_avg_sq"].numpy(),
                                          want[f"{prefix}/0/nu/{key}"])
            assert float(opt.state[p]["step"]) == opt.count
    for prefix, model in (("generator", state.generator),
                          ("discriminator", state.critic),
                          ("g_ema", state.g_ema)):
        for name, v in model.state_dict().items():
            np.testing.assert_array_equal(
                v.numpy(), want[f"{prefix}/{name.replace('.', '/')}"])
    # and the port trains on from it
    out = api.train(cfg.override(**{"io.resume": path, "train.steps": 3}),
                    device="cpu", echo=False)
    assert _arrays(out["checkpoint"])["step"] == 3


def test_port_checkpoint_resumes_in_the_jax_trainer(tmp_path):
    cfg = _cfg("gan", tmp_path, **{"train.steps": 1})
    api.train(cfg, device="cpu", echo=False)
    jcfg = JConfig.from_dict(cfg.override(**{
        "train.steps": 2, "io.resume": "auto", "dist.dp": 1}).to_dict())
    res = j_train(jcfg, echo=False)
    assert int(res["state"].step) == 2 and not res["preempted"]
    assert res["checkpoint"].endswith("step_00000002")


def test_resume_auto_walks_back_and_refuses_when_none_loads(tmp_path, capsys):
    kw = {"train.steps": 2, "io.ckpt_every": 1}
    api.train(_cfg("gan", tmp_path, **kw), device="cpu", echo=False)
    ckpts = all_checkpoints(str(tmp_path / "ckpt"))
    assert [os.path.basename(p) for p in ckpts] == ["step_00000001",
                                                    "step_00000002"]
    npz = os.path.join(ckpts[-1], "arrays.npz")
    with open(npz, "r+b") as fh:
        fh.truncate(os.path.getsize(npz) // 2)
    res = api.train(_cfg("gan", tmp_path, **{**kw, "train.steps": 3,
                                             "io.resume": "auto"}),
                    device="cpu", echo=False)
    assert "skipping unreadable checkpoint" in capsys.readouterr().out
    assert res["checkpoint"].endswith("step_00000003")
    assert [r["step"] for r in _metrics(tmp_path)] == [1, 2, 2, 3]

    for path in all_checkpoints(str(tmp_path / "ckpt")):
        os.remove(os.path.join(path, "arrays.npz"))
        open(os.path.join(path, "arrays.npz"), "wb").close()
    with pytest.raises(RuntimeError, match="none loadable"):
        api.train(_cfg("gan", tmp_path, **{**kw, "io.resume": "auto"}),
                  device="cpu", echo=False)
    with pytest.raises(FileNotFoundError, match="not found"):
        api.train(_cfg("gan", tmp_path, **{
            "io.resume": str(tmp_path / "nowhere")}), device="cpu",
            echo=False)


def test_load_refuses_another_model_shape_and_prng_impl(tmp_path):
    cfg = _cfg("gan", tmp_path, **{"train.steps": 1})
    path = api.train(cfg, device="cpu", echo=False)["checkpoint"]
    narrow = tstate.create_state(cfg.override(**{"model.base_channels": 8}),
                                 "cpu", seed=5)
    before = {k: v.clone() for k, v in narrow.generator.state_dict().items()}
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(path, narrow)
    for k, v in narrow.generator.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert narrow.step == 0 and narrow.opt_g.count == 0
    with pytest.raises(ValueError, match="prng_impl"):
        load_checkpoint(path, tstate.create_state(cfg, "cpu"),
                        prng_impl="rbg")


def test_debug_nans_checks_each_step_under_anomaly_mode(tmp_path,
                                                       monkeypatch):
    seen = []

    def fake_step(cfg, cond_scale=None):
        def step_fn(state, batch, noise=None, generator=None):
            seen.append(torch.is_anomaly_enabled())
            state.step += 1
            bad = float("nan") if state.step == 2 else 1.0
            return state, {"d_loss": torch.tensor(1.0),
                           "g_loss": torch.tensor(bad),
                           "gen_hist": torch.ones(8)}
        return step_fn

    monkeypatch.setitem(api._STEPS, "gan", fake_step)
    cfg = _cfg("gan", tmp_path, **{"train.steps": 3, "io.debug_nans": True})
    with pytest.raises(FloatingPointError, match="'g_loss' is nan at step 2"):
        api.train(cfg, device="cpu", echo=False)
    assert seen == [True, True] and not torch.is_anomaly_enabled()
    api.train(cfg.override(**{"io.debug_nans": False,
                              "io.out_dir": str(tmp_path / "off")}),
              device="cpu", echo=False)
    assert seen[2:] == [False] * 3


@pytest.mark.skipif(threading.current_thread() is not threading.main_thread(),
                    reason="signal handlers install on the main thread only")
def test_stop_request_restores_handlers_and_reraises_a_second_signal():
    got = []
    old = signal.signal(signal.SIGINT, lambda s, f: got.append(s))
    try:
        stop = api._StopRequest()
        os.kill(os.getpid(), signal.SIGINT)
        assert stop.requested and not got
        os.kill(os.getpid(), signal.SIGINT)     # the second: re-raised
        assert got == [signal.SIGINT]
        assert signal.getsignal(signal.SIGTERM) != stop._handle
    finally:
        signal.signal(signal.SIGINT, old)


def test_cli_exits_0_on_sigterm_and_resume_auto_finishes(tmp_path):
    out = str(tmp_path / "run")
    args = ["--device", "cpu", "--set", "train.steps=40", "--out", out]
    for k, v in TINY.items():
        args += ["--set", f"{k}={v}"]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen([sys.executable, "-m", "levelgan_torch.cli.train",
                             *args], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    metrics = os.path.join(out, "metrics.jsonl")
    deadline = time.monotonic() + 60
    try:
        while not (os.path.exists(metrics) and os.path.getsize(metrics)):
            assert proc.poll() is None, proc.communicate()[0]
            assert time.monotonic() < deadline, "no step logged in 60 s"
            time.sleep(0.01)
        proc.send_signal(signal.SIGTERM)
        text = proc.communicate(timeout=60)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, text
    assert "preempted: checkpoint=" in text
    stopped = all_checkpoints(os.path.join(out, "ckpt"))
    assert len(stopped) == 1
    stop_step = int(_arrays(stopped[0])["step"])
    assert 1 <= stop_step < 40
    assert cli_train.main(["--preset", "toy_dcgan_16", *args,
                           "--resume", "auto"]) == 0
    final = all_checkpoints(os.path.join(out, "ckpt"))[-1]
    assert int(_arrays(final)["step"]) == 40
    steps = [r["step"] for r in _metrics(out)]
    assert steps == list(range(1, stop_step + 1)) + list(
        range(stop_step + 1, 41))
