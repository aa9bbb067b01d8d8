"""``io.render_every``, ``io.profile`` and ``io.tensorboard`` in the port's
``api.train``, on the CPU.

One short run of the port and one of the JAX package (one step a
dispatch, so the JAX cadences fire at every crossing as the port's do)
write their renders and TensorBoard scalars; both must hold the same
files and the same tags at the same steps.  The trace is read back for
its window: the JAX package's at one step a dispatch, from the second
step of the run to its thirteenth.
"""

import json
import os
import sys

import numpy as np
import pytest

from levelgan.config import Config as JConfig
from levelgan_torch import api
from levelgan_torch.cli.export import render_levels_rgb
from levelgan_torch.config import preset
from levelgan_torch.export import generate
from levelgan_torch.lio.checkpoint import all_checkpoints, load_checkpoint
from levelgan_torch.train import state as tstate
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = {"model.level_size": 16, "model.base_channels": 16,
        "model.critic_base_channels": 16, "model.group_size": 8,
        "model.latent_dim": 8, "model.dtype": "float32",
        "train.batch_size": 4, "data.corpus_size": 16, "io.log_every": 1,
        "train.steps_per_dispatch": 1, "io.compile_cache": ""}
STEPS, RENDER = 14, 4


def _cfg(out, **kw):
    return preset("toy_dcgan_16").override(**{
        **TINY, "train.steps": STEPS, "io.render_every": RENDER,
        "io.profile": True, "io.tensorboard": True, "io.out_dir": str(out),
        "io.ckpt_every": 12, **kw})


def _scalars(tb_dir):
    """{tag: [(step, value)]} of a TensorBoard run directory."""
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator
    acc = EventAccumulator(str(tb_dir))
    acc.Reload()
    return {t: [(e.step, e.value) for e in acc.Scalars(t)]
            for t in acc.Tags()["scalars"]}


def _trace_steps(path):
    """The steps whose ranges the trace holds: each step's ``train.inputs``
    and ``train.step`` spans, named with the step's number."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return sorted({int(e["name"].split()[1]) for e in events
                   if e.get("name", "").startswith(("train.inputs ",
                                                    "train.step "))})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("io")
    cfg = _cfg(root / "port")
    api.train(cfg, device="cpu", echo=False)
    from levelgan.api import train as j_train
    jcfg = JConfig.from_dict(cfg.override(**{
        "train.steps": 2 * RENDER, "io.profile": False, "dist.dp": 1,
        "io.out_dir": str(root / "jax")}).to_dict())
    j_train(jcfg, echo=False)
    return cfg, root / "port", root / "jax"


def test_render_every_writes_the_jax_packages_files(runs):
    cfg, port, jax_out = runs
    got = sorted(f for f in os.listdir(port) if f.startswith("levels_"))
    assert got == [f"levels_{s:08d}.png" for s in range(RENDER, STEPS + 1,
                                                         RENDER)]
    want = sorted(f for f in os.listdir(jax_out) if f.startswith("levels_"))
    assert want == got[:len(want)] and len(want) == 2
    # a render is its step's EMA's 16 levels at seed=step, 4 a row
    from PIL import Image
    path = all_checkpoints(str(port / "ckpt"))[0]
    assert path.endswith("step_00000012")
    state = load_checkpoint(path, tstate.create_state(cfg, "cpu"))[0]
    levels = generate(cfg, state.g_ema, 16, batch_size=16, seed=12,
                      device="cpu")
    img = np.asarray(Image.open(port / "levels_00000012.png"))
    np.testing.assert_array_equal(img, render_levels_rgb(levels, cols=4))


def test_tensorboard_holds_every_logged_scalar_as_the_jax_package(runs):
    _, port, jax_out = runs
    got, want = _scalars(port / "tb"), _scalars(jax_out / "tb")
    assert sorted(got) == sorted(want)
    with open(port / "metrics.jsonl") as fh:
        logged = [json.loads(s) for s in fh.read().splitlines()]
    for tag, events in got.items():
        assert [s for s, _ in events] == list(range(1, STEPS + 1)), tag
        assert [s for s, _ in want[tag]] == list(range(1, 2 * RENDER + 1))
        np.testing.assert_allclose([v for _, v in events],
                                   [r[tag] for r in logged], rtol=1e-6,
                                   err_msg=tag)


def test_profile_traces_the_jax_window(runs):
    _, port, _ = runs
    path = port / "profile" / "trace.json"
    assert _trace_steps(path) == list(range(2, 14))


def test_a_run_that_ends_or_fails_inside_the_window_writes_its_trace(
        tmp_path, monkeypatch):
    cfg = _cfg(tmp_path / "short", **{"train.steps": 5, "io.render_every": 0,
                                      "io.tensorboard": False,
                                      "io.profile_dir": str(tmp_path / "p")})
    api.train(cfg, device="cpu", echo=False)
    assert _trace_steps(tmp_path / "p" / "trace.json") == [2, 3, 4, 5]
    make = api.make_step_fn

    def failing(cfg_, cond_scale=None):
        step = make(cfg_, cond_scale)

        def fn(state, batch, noise=None):
            if state.step == 3:
                raise RuntimeError("step failed")
            return step(state, batch, noise=noise)
        return fn

    monkeypatch.setattr(api, "make_step_fn", failing)
    with pytest.raises(RuntimeError, match="step failed"):
        api.train(cfg.override(**{"io.out_dir": str(tmp_path / "fail"),
                                  "io.profile_dir": ""}),
                  device="cpu", echo=False)
    assert _trace_steps(tmp_path / "fail" / "profile" / "trace.json") == [
        2, 3, 4]


def test_without_tensorboard_or_pil_the_run_keeps_to_jsonl_and_npz(
        tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    cfg = _cfg(tmp_path, **{"train.steps": 2, "io.render_every": 2,
                            "io.profile": False})
    api.train(cfg, device="cpu")
    out = capsys.readouterr().out
    assert "tensorboard requested but not installed; JSONL metrics only" \
        in out
    assert not (tmp_path / "tb").exists()
    with np.load(tmp_path / "levels_00000002.png.npz") as z:
        assert z["rgb"].shape == (4 * 16 * 8, 4 * 16 * 8, 3)   # 4 x 4
    assert len(open(tmp_path / "metrics.jsonl").read().splitlines()) == 2


def test_a_track_run_renders_tracks(tmp_path):
    cfg = preset("racetrack_32").override(**{
        "model.n_segments": 16, "model.rnn_hidden": 16,
        "model.critic_base_channels": 8, "model.group_size": 4,
        "model.latent_dim": 8, "train.batch_size": 4, "train.n_critic": 1,
        "data.corpus_size": 16, "train.steps": 1, "io.render_every": 1,
        "io.out_dir": str(tmp_path)})
    api.train(cfg, device="cpu", echo=False)
    from PIL import Image
    assert np.asarray(Image.open(tmp_path / "tracks_00000001.png")).shape \
        == (4 * 128, 4 * 128)
