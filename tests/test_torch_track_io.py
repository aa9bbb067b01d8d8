"""The track family's checkpoints, export and gates in the port, held to
the JAX package on the CPU: full-state checkpoints both ways (the JAX
package's ``load_checkpoint`` and ``tools.gate_all``, skill gap included,
read a port checkpoint; the port resumes a JAX one), 2 + 1 resumed steps
= 3, ``export.generate`` with and without the closure repair against the
JAX export from the same z (f32, 1e-5 absolute), the export and validate
CLIs, and the corpus-mean condition.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelgan.config import preset as j_preset
from levelgan.export import generate as j_generate
from levelgan.lio.checkpoint import load_checkpoint as j_load_checkpoint
from levelgan.lio.checkpoint import save_checkpoint as j_save_checkpoint
from levelgan.track.train import create_track_curriculum_state as j_create_c
from levelgan.track.train import create_track_state as j_create
from levelgan_torch import api, export
from levelgan_torch.bridge import (agent_params_from_flat,
                                   agent_params_to_flat,
                                   generator_params_from_flat,
                                   generator_params_to_flat)
from levelgan_torch.cli import export as cli_export
from levelgan_torch.cli import validate as cli_validate
from levelgan_torch.config import Config
from levelgan_torch.lio.checkpoint import load_checkpoint
from levelgan_torch.track.data import KAPPA_MAX
from levelgan_torch.track.models import TrackGenerator
from levelgan_torch.train.state import create_state
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

T = 16
TINY = {"train.batch_size": 4, "train.n_critic": 2, "model.n_segments": T,
        "model.rnn_hidden": 16, "model.critic_base_channels": 8,
        "model.group_size": 4, "model.latent_dim": 8,
        "model.dtype": "float32", "curriculum.rollout_steps": 8,
        "data.corpus_size": 32, "io.log_every": 1}


def _flat(tree, prefix):
    return {f"{prefix}/" + jax.tree_util.keystr(p, simple=True, separator="/"):
            np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jcfg(name, **kw):
    return j_preset(name).override(**TINY, **kw)


def _cfg(name, **kw):
    return Config.from_dict(_jcfg(name, **kw).to_dict())


def _run(cfg, out, steps, resume=""):
    return api.train(cfg.override(**{"io.out_dir": str(out),
                                     "train.steps": steps,
                                     "io.resume": resume}),
                     device="cpu", echo=False)


def _arrays(path):
    with np.load(os.path.join(path, "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name", ["racetrack_32", "race_curriculum_32"])
def test_port_checkpoint_restores_in_jax(tmp_path, name):
    """Every array of a port checkpoint, Adam counts and moments, drivers
    and baseline included, as the JAX package restores it."""
    path = _run(_cfg(name), tmp_path, 2)["checkpoint"]
    make = j_create_c if name == "race_curriculum_32" else j_create
    restored, cfg2 = j_load_checkpoint(path, make(_jcfg(name),
                                                  jax.random.key(7)))
    assert cfg2.preset == name and int(restored.step) == 2
    arrays = _arrays(path)
    fields = [("generator", "generator"), ("discriminator", "discriminator"),
              ("g_ema", "g_ema")]
    if name == "race_curriculum_32":
        fields += [("agent_strong", "agent_strong"),
                   ("agent_weak", "agent_weak")]
        assert float(restored.g_baseline) == float(arrays["g_baseline"]) != 0
        assert int(restored.opt_aw[0].count) == 2
        fields.append(("opt_as", "opt_as"))
    fields.append(("opt_d", "opt_d"))
    for field, prefix in fields:
        got = _flat(getattr(restored, field), prefix)
        got = {k: v for k, v in got.items() if k in arrays}
        assert got, field
        for k, v in got.items():
            np.testing.assert_array_equal(v, arrays[k], err_msg=k)
    assert int(restored.opt_d[0].count) == 2 * 2


def test_gate_all_reads_a_port_curriculum_checkpoint(tmp_path):
    """``tools.gate_all`` (identity informative, quality, skill gap with
    the checkpoint's own drivers) runs on a port race-curriculum
    checkpoint; the port's validate gives the same gate set."""
    from tools.gate_all import gate_checkpoint
    path = _run(_cfg("race_curriculum_32"), tmp_path, 2)["checkpoint"]
    row = gate_checkpoint(path, n=64, seed=0, chi2_threshold=20.0,
                          solvable_threshold=0.9)
    gates = row["gates"]
    assert set(gates) == {"identity", "identity_shipped", "quality",
                          "skillgap"}
    assert gates["identity"]["informative"]
    assert np.isfinite(gates["skillgap"]["separation"])
    args = cli_validate.build_parser().parse_args(
        ["--ckpt", path, "--n", "64", "--quality-n", "64", "--device",
         "cpu"])
    report, tracks = cli_validate.validate(args)
    assert set(report["gates"]) == set(gates)
    assert report["gates"]["identity"]["informative"]
    assert np.isfinite(report["gates"]["skillgap"]["separation"])
    assert report["passed"] == all(
        g["passed"] for k, g in report["gates"].items()
        if k in ("quality", "skillgap"))
    assert report["gates"]["identity"]["threshold"] == 0.1
    assert tracks["raw"].shape == (report["n_levels"], T, 2)
    # gate_all's quality gate and the port's agree on the corpus side
    assert (report["gates"]["quality"]["corpus_lap_frac"]
            == gates["quality"]["corpus_lap_frac"])


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A JAX race-curriculum state, saved by the JAX package, restores
    into the port exactly and the port trains on from it."""
    jcfg = _jcfg("race_curriculum_32")
    j_state = j_create_c(jcfg, jax.random.key(3)).replace(
        step=jnp.int32(1), g_baseline=jnp.float32(0.5))
    path = j_save_checkpoint(str(tmp_path / "ckpt"), j_state, jcfg)
    cfg = Config.from_dict(jcfg.to_dict())
    state = load_checkpoint(path, create_state(cfg, "cpu"))[0]
    assert state.step == 1 and float(state.g_baseline) == 0.5
    for field, prefix in (("generator", "generator"),
                          ("critic", "discriminator"),
                          ("agent_weak", "agent_weak")):
        want = _flat(getattr(j_state, "discriminator" if field == "critic"
                             else field), prefix)
        for k, v in getattr(state, field).state_dict().items():
            np.testing.assert_array_equal(
                v.numpy(), want[f"{prefix}/{k.replace('.', '/')}"])
    res = _run(cfg, tmp_path, 2, resume="auto")
    assert os.path.basename(res["checkpoint"]) == "step_00000002"


def test_resumed_port_run_equals_an_uninterrupted_one(tmp_path):
    cfg = _cfg("race_curriculum_32")
    whole = _run(cfg, tmp_path / "whole", 3)["checkpoint"]
    _run(cfg, tmp_path / "parts", 2)
    parts = _run(cfg, tmp_path / "parts", 3, resume="auto")["checkpoint"]
    a, b = _arrays(whole), _arrays(parts)
    assert set(a) == set(b) and "opt_aw/0/nu/Dense_3/bias" in a
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _jax_generator(jcfg):
    from levelgan.track.models import TrackGenerator as JGen
    m = jcfg.model
    return JGen(m).init(jax.random.key(4), jnp.zeros((2, m.latent_dim)),
                        None)["params"]


def _jax_z(jcfg, n, batch, seed):
    """The z the JAX track export draws (``export.py:260-263``)."""
    key = jax.random.key(seed, impl=jcfg.train.prng_impl)
    zs = []
    for _ in range(0, n, batch):
        key, sub = jax.random.split(key)
        zs.append(np.asarray(jax.random.normal(
            sub, (batch, jcfg.model.latent_dim), jnp.float32)))
    return np.concatenate(zs)[:n]


@pytest.mark.parametrize("repair", [False, True])
def test_generate_matches_jax_with_and_without_repair(repair):
    jcfg = _jcfg("race_curriculum_32")          # closure_in_model off
    pg = _jax_generator(jcfg)
    want = j_generate(jcfg, pg, 10, seed=5, batch_size=4, repair=repair)
    params = generator_params_from_flat(_flat(pg, "generator"))
    got = export.generate(Config.from_dict(jcfg.to_dict()), params, 10,
                          batch_size=4, repair=repair, device="cpu",
                          z=_jax_z(jcfg, 10, 4, 5))
    assert got.dtype == np.float32 and got.shape == (10, T, 2)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    closed = np.abs(np.abs(got[..., 0].sum(-1)) - 2 * np.pi) < 1e-4
    assert closed.all() == repair
    assert (np.abs(got[..., 0]) <= KAPPA_MAX).all()


def test_export_cli_writes_npz_and_png(tmp_path):
    cfg = _cfg("racetrack_32")
    gen = TrackGenerator(cfg.model).init_params(
        torch.Generator().manual_seed(1))
    from levelgan_torch.lio.checkpoint import save_checkpoint
    ckpt = save_checkpoint(str(tmp_path / "ckpt"), gen, cfg, step=1)
    out = tmp_path / "t.npz"
    assert cli_export.main(["--ckpt", ckpt, "--n", "9", "--batch", "4",
                            "--out", str(out), "--device", "cpu"]) == 0
    tracks = np.load(out)["tracks"]
    assert tracks.dtype == np.float32 and tracks.shape == (9, T, 2)
    np.testing.assert_array_equal(tracks, export.generate(
        cfg, gen, 9, batch_size=4, device="cpu"))
    np.testing.assert_allclose(np.abs(tracks[..., 0].sum(-1)), 2 * np.pi,
                               atol=1e-4)
    png = tmp_path / "t.png"
    assert cli_export.main(["--ckpt", ckpt, "--n", "4", "--out", str(png),
                            "--device", "cpu", "--no-repair"]) == 0
    assert png.stat().st_size > 0 or (tmp_path / "t.png.npz").exists()


def test_corpus_mean_cond_and_bridge_round_trip():
    from levelgan.api import make_dataset as j_make_dataset
    from levelgan.data.features import corpus_mean_cond as j_mean_cond
    from levelgan_torch.data.features import corpus_mean_cond
    jcfg = _jcfg("racetrack_32", **{"model.cond_dim": 4})
    cfg = Config.from_dict(jcfg.to_dict())
    np.testing.assert_allclose(
        corpus_mean_cond(cfg, api.make_dataset(cfg), "cpu"),
        j_mean_cond(jcfg, j_make_dataset(jcfg)), atol=1e-6)
    state = create_state(_cfg("race_curriculum_32"), "cpu", seed=2)
    flat = {**generator_params_to_flat(state.generator.state_dict()),
            **agent_params_to_flat(state.agent_weak.state_dict(),
                                   "agent_weak")}
    back = generator_params_from_flat(flat)
    for k, v in state.generator.state_dict().items():
        assert torch.equal(back[k], v), k
    back = agent_params_from_flat(flat, "agent_weak")
    for k, v in state.agent_weak.state_dict().items():
        assert torch.equal(back[k], v), k
    assert "generator/gru/in/kernel" in flat


def test_validate_report_on_a_racetrack_checkpoint_is_json(tmp_path):
    path = _run(_cfg("racetrack_32"), tmp_path, 1)["checkpoint"]
    out = tmp_path / "v.json"
    rc = cli_validate.main(["--ckpt", str(tmp_path), "--n", "32",
                            "--quality-n", "16", "--device", "cpu",
                            "--out", str(out)])
    report = json.loads(out.read_text())
    assert rc == (0 if report["passed"] else 1)
    assert not any(g.get("informative") for g in report["gates"].values())
    assert report["ckpt"] == str(tmp_path) and path
