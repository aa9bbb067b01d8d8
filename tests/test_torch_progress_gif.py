"""``python -m levelgan_torch.cli.progress_gif`` on the CPU: one frame a
checkpoint, oldest first, each the port's export of that checkpoint at
the shared seed drawn with the export CLI's palette (the JAX tool's
layout: ``cols`` levels a row, ``scale`` pixels a tile, condition 0.25
where the model is conditional); the ``.npz`` without PIL."""

import sys

import numpy as np
import pytest

from levelgan_torch import api
from levelgan_torch.cli import progress_gif
from levelgan_torch.cli.export import load_generator, render_levels_rgb
from levelgan_torch.config import preset
from levelgan_torch.export import generate
from levelgan_torch.lio.checkpoint import all_checkpoints
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = {"model.level_size": 16, "model.base_channels": 16,
        "model.critic_base_channels": 16, "model.group_size": 8,
        "model.latent_dim": 8, "train.batch_size": 4, "train.n_critic": 2,
        "data.corpus_size": 16, "train.steps": 3, "io.ckpt_every": 1,
        "io.log_every": 1}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("gif")
    cfg = preset("conditional_32").override(**{**TINY,
                                               "io.out_dir": str(out)})
    api.train(cfg, device="cpu", echo=False)
    return out


def test_one_frame_a_checkpoint_at_the_shared_seed(run):
    ckpts = all_checkpoints(str(run / "ckpt"))
    assert len(ckpts) == 3
    assert progress_gif.main([str(run), "--device", "cpu", "--n", "8",
                              "--seed", "5"]) == 0
    from PIL import Image
    gif = Image.open(run / "progress.gif")
    assert gif.n_frames == 3
    for i, path in enumerate(ckpts):
        _, cfg, params = load_generator(path)
        levels = generate(cfg, params, 8, seed=5, device="cpu",
                          cond=np.full(4, 0.25, np.float32))
        want = render_levels_rgb(levels, scale=8, cols=4)
        gif.seek(i)
        frame = np.asarray(gif.convert("RGB"))
        assert frame.shape == want.shape
        # GIF frames are palette images: the eight tile colours survive
        np.testing.assert_array_equal(frame, want)


def test_without_pil_the_frames_go_to_an_npz(run, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    out = tmp_path / "p.gif"
    assert progress_gif.main([str(run / "ckpt"), "--device", "cpu", "--n",
                              "4", "--cols", "2", "--scale", "2", "--out",
                              str(out)]) == 0
    with np.load(str(out) + ".npz") as z:
        assert z["frames"].shape == (3, 2 * 16 * 2, 2 * 16 * 2, 3)
    with pytest.raises(SystemExit, match="no checkpoints"):
        progress_gif.main([str(tmp_path), "--device", "cpu"])
