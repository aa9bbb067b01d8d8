"""Port hygiene: import isolation and the device rule of the entry points."""

import subprocess
import sys

import pytest
import torch

_MODULES = [
    "levelgan_torch", "levelgan_torch.config", "levelgan_torch.device",
    "levelgan_torch.ops.blocks", "levelgan_torch.ops.gumbel",
    "levelgan_torch.data.codec", "levelgan_torch.kernels.build",
    "levelgan_torch.kernels.upsample_block",
    "levelgan_torch.kernels.upsample_rows", "levelgan_torch.models",
    "levelgan_torch.bridge", "levelgan_torch.lio.checkpoint",
    "levelgan_torch.export", "levelgan_torch.cli.export", "chip_smoke",
]


def test_port_imports_neither_jax_nor_levelgan():
    code = (
        "import importlib, sys\n"
        f"for m in {_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib', 'flax')) or m == 'levelgan' or "
        "m.startswith('levelgan.'))\n"
        "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=str(_repo()))
    assert out.stdout.strip() == "", f"port pulled in: {out.stdout.strip()}"


def _repo():
    from pathlib import Path
    return Path(__file__).resolve().parent.parent


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_needs_explicit_cpu(no_gpu):
    from levelgan_torch.device import resolve_device
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_generate_and_cli_raise_without_gpu(no_gpu, tmp_path):
    from levelgan_torch.cli import export as cli
    from levelgan_torch.config import Config, ModelConfig
    from levelgan_torch.export import generate
    from levelgan_torch.lio.checkpoint import save_checkpoint
    from levelgan_torch.models import Generator

    cfg = Config(model=ModelConfig(level_size=16, base_channels=16,
                                   group_size=8, latent_dim=8,
                                   dtype="float32"))
    gen = Generator(cfg.model).init_params(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError):
        generate(cfg, gen, 4)
    ckpt = save_checkpoint(str(tmp_path / "ckpt"), gen, cfg)
    with pytest.raises(RuntimeError):
        cli.main(["--ckpt", ckpt, "--n", "4", "--out",
                  str(tmp_path / "l.npz")])
    assert cli.main(["--ckpt", ckpt, "--n", "4", "--out",
                     str(tmp_path / "l.txt"), "--device", "cpu"]) == 0


def test_chip_smoke_refuses_without_gpu(no_gpu):
    import chip_smoke
    assert chip_smoke.main() != 0


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    """A directory holding chip_smoke.py alone must not pass the run."""
    import shutil
    shutil.copy(_repo() / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True)
    assert out.returncode != 0 and '"ok": true' not in out.stdout


def test_kernel_wrappers_refuse_other_devices():
    from levelgan_torch.kernels import upsample_block as k1
    from levelgan_torch.kernels import upsample_rows as k1l
    x = torch.empty(2, 4, 4, 64, device="meta")
    w = torch.empty(4, 4, 64, 32, device="meta")
    g = torch.empty(32, device="meta")
    with pytest.raises(ValueError):
        k1.upsample_block_fwd(x, w, g, g)
    with pytest.raises(ValueError):
        k1l.upsample_rows_fwd(x, w)
