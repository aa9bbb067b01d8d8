"""Port parity for the whole export slice, on the CPU in f32.

The JAX ``make_generate_fn(..., pack=True)`` draws z and the Gumbel noise
from its key; the test re-draws the same numbers from the same key splits
and hands them to the port, so the packed bytes must agree.  A tile may
differ only at a near-tie of the perturbed logits (top-2 gap < 1e-5),
where f32 rounding in two frameworks may pick either.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from levelgan.config import Config as JConfig
from levelgan.config import ModelConfig as JModelConfig
from levelgan.config import PRESET_NAMES
from levelgan.config import preset as j_preset
from levelgan.export import make_generate_fn
from levelgan.export import unpack_levels as j_unpack_levels
from levelgan.models import Generator as JGenerator
from levelgan_torch import export as texport
from levelgan_torch.bridge import generator_params_from_flat
from levelgan_torch.config import Config
from levelgan_torch.lio.checkpoint import (latest_checkpoint,
                                           load_generator_params,
                                           load_manifest, save_checkpoint)
from levelgan_torch.models import Generator
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

NEAR_TIE = 1e-5
B = 8


def _cfgs(head="gumbel", level_size=16):
    m = dict(level_size=level_size, base_channels=16, group_size=8,
             latent_dim=8, dtype="float32", head=head)
    jcfg = JConfig(model=JModelConfig(**m))
    return jcfg, Config.from_dict(jcfg.to_dict())


def _jax_params(jcfg, seed=0):
    m = jcfg.model
    params = JGenerator(m).init(jax.random.key(seed),
                                jnp.zeros((2, m.latent_dim)))["params"]
    rng = np.random.default_rng(seed)
    # widen the init so the logits, not the noise, decide most tiles
    params = jax.tree_util.tree_map(
        lambda a: a + 0.3 * rng.standard_normal(a.shape).astype(np.float32),
        params)
    flat = {jax.tree_util.keystr(p, simple=True, separator="/"): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    return params, flat


def _jax_draws(jcfg, key, params):
    """The z and Gumbel draws make_generate_fn takes from ``key``."""
    m = jcfg.model
    k_z, k_s = jax.random.split(key)
    z = jax.random.normal(k_z, (B, m.latent_dim), jnp.float32)
    logits = JGenerator(m).apply({"params": params}, z)
    noise = jax.random.gumbel(k_s, logits.shape, logits.dtype)
    return np.array(z), np.array(noise), np.array(logits)


@pytest.mark.parametrize("head", ["gumbel", "softmax"])
def test_packed_export_matches_jax(head):
    jcfg, tcfg = _cfgs(head)
    params, flat = _jax_params(jcfg)
    key = jax.random.key(5)
    want = np.asarray(make_generate_fn(jcfg, B, pack=True)(params, key))
    z, noise, logits = _jax_draws(jcfg, key, params)

    gen = texport.make_generator(tcfg, generator_params_from_flat(flat), "cpu")
    got = texport.generate_batch(gen, tcfg, torch.from_numpy(z),
                                 noise=torch.from_numpy(noise),
                                 pack=True).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert got.shape[1] == texport.packed_bytes(tcfg.model)

    if head == "gumbel":
        pert = np.sort(logits + noise, axis=-1)   # tau > 0 keeps the argmax
    else:
        pert = np.sort(logits, axis=-1)
    tie = (pert[..., -1] - pert[..., -2]) < NEAR_TIE           # [B, H, W]
    tie_group = tie.reshape(B, -1, 8).any(-1)                  # per 8 tiles
    bits = texport.tile_bits(tcfg.model.n_tiles)
    same = (got == want).reshape(B, -1, bits).all(-1)
    assert np.all(same | tie_group), "packed bytes differ away from near-ties"

    levels = texport.generate(tcfg, gen, B, z=z, noise=noise, device="cpu",
                              batch_size=4)
    ids_j = j_unpack_levels(want, tcfg.model.level_size)
    assert np.all((levels == ids_j) | tie)


def test_unpack_levels_roundtrip_and_jax_format():
    rng = np.random.default_rng(0)
    for n_tiles, size in ((8, 16), (2, 8), (100, 16)):
        ids = rng.integers(0, n_tiles, (5, size, size), dtype=np.uint8)
        packed = texport.pack_levels(torch.from_numpy(ids),
                                     texport.tile_bits(n_tiles)).numpy()
        np.testing.assert_array_equal(texport.unpack_levels(packed, size), ids)
        np.testing.assert_array_equal(j_unpack_levels(packed, size), ids)
    out = np.empty((5, size, size), np.uint8)
    assert texport.unpack_levels(packed, size, out=out) is out


def test_export_policy_and_wire_format_match_jax():
    from levelgan.export import packed_bytes as j_packed_bytes
    from levelgan.export import resolve_export_policy as j_policy
    for name in ("gumbel_64", "racetrack_32", "wgan_gp_32_structural"):
        jcfg = j_preset(name)
        tcfg = Config.from_dict(jcfg.to_dict())
        for repair in (None, True, False):
            assert (texport.resolve_export_policy(tcfg, repair)
                    == j_policy(jcfg, repair))
        assert texport.packed_bytes(tcfg.model) == j_packed_bytes(jcfg.model)


def test_repair_and_track_raise_not_implemented(tmp_path):
    """The track family exports since its slice; what it still refuses, as
    the JAX package does: ``pack=True`` and outputs other than .npz and
    .png."""
    from levelgan_torch.cli import export as cli
    from levelgan_torch.track.models import TrackGenerator
    track = Config.from_dict(j_preset("racetrack_32").override(**{
        "model.rnn_hidden": 16, "model.n_segments": 16}).to_dict())
    gen = TrackGenerator(track.model).init_params(
        torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="pack=True is tile-family only"):
        texport.generate(track, gen, 4, device="cpu", pack=True)
    assert texport.generate(track, gen, 4, device="cpu").shape == (4, 16, 2)
    # the CLI on a track checkpoint, with the repair flags it also takes
    ckpt = save_checkpoint(str(tmp_path), gen, track, step=1)
    with pytest.raises(SystemExit, match=".npz or .png"):
        cli.main(["--ckpt", ckpt, "--n", "2", "--out",
                  str(tmp_path / "t.txt"), "--device", "cpu", "--repair"])


def test_repair_runs_by_flag_and_by_config_policy():
    from levelgan_torch.env.solver import solvable, well_formed
    _, tcfg = _cfgs()
    gen = Generator(tcfg.model).init_params(torch.Generator().manual_seed(2))
    on = tcfg.override(**{"io.export_repair": "on"})
    for cfg, repair in ((tcfg, True), (on, None)):
        levels = torch.from_numpy(texport.generate(
            cfg, gen, 6, repair=repair, device="cpu", batch_size=4))
        wf = well_formed(levels)
        # exactly_one follows the policy: 'auto' = on when repairing
        assert wf["one_start"].all() and wf["one_goal"].all()
        assert solvable(levels).all()


def _parent_loop(cfg, gen, n, seed, batch_size, pack):
    """The export loop as it was before the streamed host path: every
    batch's z and noise from one generator, concatenated, then unpacked."""
    rng = torch.Generator("cpu").manual_seed(seed)
    chunks = []
    for _ in range(0, n, batch_size):
        z = torch.randn((batch_size, cfg.model.latent_dim), generator=rng)
        chunks.append(texport.generate_batch(gen, cfg, z, generator=rng,
                                             pack=pack))
    host = torch.cat(chunks).numpy()
    side = cfg.model.level_size
    levels = (texport.unpack_levels_plain(host, side) if pack
              else host.reshape(-1, side, side))
    return levels[:n]


@pytest.mark.parametrize("pack", [True, False])
def test_fixed_seed_export_equals_the_unstreamed_loop(pack):
    _, tcfg = _cfgs()
    gen = Generator(tcfg.model).init_params(torch.Generator().manual_seed(1))
    got = texport.generate(tcfg, gen, 11, seed=5, batch_size=4, pack=pack,
                           repair=False, device="cpu")
    want = _parent_loop(tcfg, gen, 11, 5, 4, pack)
    assert got.shape == (11, 16, 16)
    np.testing.assert_array_equal(got, want)


def test_pack_none_resolves_per_device():
    _, tcfg = _cfgs()
    m = tcfg.model
    assert texport.resolve_pack(m, None, torch.device("cpu"))
    assert (texport.resolve_pack(m, None, torch.device("cuda"))
            == texport.PACK_ON_CUDA)
    with pytest.raises(ValueError, match="packing"):
        texport.resolve_pack(tcfg.override(**{"model.n_tiles": 200}).model,
                             True, torch.device("cpu"))


def test_jax_checkpoint_exports_through_port_cli(tmp_path):
    from levelgan.lio.checkpoint import save_checkpoint as j_save
    from levelgan.train.state import create_state
    from levelgan_torch.cli import export as cli

    jcfg, _ = _cfgs()
    state = create_state(jcfg, jax.random.key(0))
    j_save(str(tmp_path / "ckpt"), state, jcfg)
    out = tmp_path / "levels.npz"
    assert cli.main(["--ckpt", str(tmp_path / "ckpt"), "--n", "6", "--batch",
                     "4", "--out", str(out), "--device", "cpu"]) == 0
    levels = np.load(out)["levels"]
    assert levels.dtype == np.uint8 and levels.shape == (6, 16, 16)
    assert levels.max() < jcfg.model.n_tiles
    # the EMA weights are the ones exported
    params, cfg = load_generator_params(latest_checkpoint(str(tmp_path / "ckpt")))
    ema = jax.tree_util.tree_leaves(state.g_ema)
    assert len(params) == len(ema)
    assert cfg == Config.from_dict(jcfg.to_dict())


def test_port_checkpoint_roundtrip_and_manifest_parses_in_jax(tmp_path):
    _, tcfg = _cfgs()
    gen = Generator(tcfg.model).init_params(torch.Generator().manual_seed(0))
    path = save_checkpoint(str(tmp_path), gen, tcfg, step=12)
    assert os.path.basename(path) == "step_00000012"
    assert not [p for p in os.listdir(tmp_path) if p.startswith(".tmp_")]
    manifest = load_manifest(path)
    assert manifest["step"] == 12 and "generator/seed/kernel" in manifest["keys"]
    assert JConfig.from_dict(manifest["config"]).to_dict() == tcfg.to_dict()
    params, cfg = load_generator_params(path)
    assert cfg == tcfg
    for k, v in gen.state_dict().items():
        assert torch.equal(params[k], v)


@pytest.mark.parametrize("name", PRESET_NAMES)
def test_presets_and_manifests_round_trip(name):
    from levelgan_torch.config import preset
    jd = j_preset(name).to_dict()
    assert preset(name).to_dict() == jd
    assert JConfig.from_dict(Config.from_dict(jd).to_dict()) == j_preset(name)


def test_port_config_is_field_for_field_copy():
    import levelgan.config as jc
    import levelgan_torch.config as tc
    for cls in ("ModelConfig", "TrainConfig", "DataConfig", "DistConfig",
                "CurriculumConfig", "IOConfig", "Config"):
        jf = [(f.name, f.type) for f in dataclasses.fields(getattr(jc, cls))]
        tf = [(f.name, f.type) for f in dataclasses.fields(getattr(tc, cls))]
        assert jf == tf, cls
    assert (tc.EMPTY, tc.WALL, tc.START, tc.GOAL, tc.HAZARD, tc.COIN) == (
        jc.EMPTY, jc.WALL, jc.START, jc.GOAL, jc.HAZARD, jc.COIN)
    assert tc.TILE_NAMES == jc.TILE_NAMES and tc.PRESET_NAMES == jc.PRESET_NAMES
