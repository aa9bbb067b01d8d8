"""The plain reference against levelgan_torch's plain path, on the CPU at
small float32 sizes, on seeded weights and injected draws."""

import ast
import dataclasses
from pathlib import Path

import pytest
import torch

from portbench import inputs
from portbench.reference import draws, params, precision, tile
from portbench.tests.conftest import TILE_SMALL

REF_DIR = Path(__file__).resolve().parents[1] / "reference"


def _tile_cfg(**extra):
    from levelgan_torch.config import preset
    return preset("gumbel_64").override(**TILE_SMALL, **extra)


def _weights(spec, seed, purpose):
    return inputs.make_params(spec, seed, purpose, "cpu")


def test_reference_imports_nothing_of_the_program():
    banned = ("levelgan_torch", "levelgan", "jax", "jaxlib", "flax")
    for path in REF_DIR.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in banned, (path.name, n)


@pytest.mark.parametrize("preset_name,spec_of,model", [
    ("gumbel_64", params.tile_generator, "Generator"),
    ("gumbel_64", params.tile_critic, "Critic")])
def test_param_spec_matches_state_dict_at_full_size(preset_name, spec_of,
                                                     model):
    from levelgan_torch import models
    from levelgan_torch.config import preset
    cfg = preset(preset_name)
    sd = getattr(models, model)(cfg.model).state_dict()
    spec = spec_of(dataclasses.asdict(cfg.model))
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: s for k, s, _ in spec}


def test_generator_logits_and_gumbel_sample_match_port():
    from levelgan_torch.models import Generator, sample_head
    cfg = _tile_cfg()
    m = dataclasses.asdict(cfg.model)
    w = _weights(params.tile_generator(m), 11, inputs.WEIGHTS_G)
    gen = Generator(cfg.model)
    gen.load_state_dict(w)
    z = torch.randn(6, m["latent_dim"], generator=torch.Generator().manual_seed(1))
    u = torch.rand(6, 16, 16, 8, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = gen(z, plain=True)
        ref = tile.generator_logits(w, z, m)
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
        g = tile.gumbel(u)
        ids = torch.argmax(sample_head(got, "gumbel", tau=0.5, noise=g), -1)
    assert torch.equal(ids, tile.sample_ids(ref, g))
    assert float(tile.sample_gap(ref, g, ids).max()) < 1e-5


def test_critic_and_gradient_penalty_match_port():
    from levelgan_torch.models import Critic
    from levelgan_torch.ops.grad_penalty import gradient_penalty
    cfg = _tile_cfg()
    m = dataclasses.asdict(cfg.model)
    w = _weights(params.tile_critic(m), 12, inputs.WEIGHTS_D)
    critic = Critic(cfg.model)
    critic.load_state_dict(w)
    gen = torch.Generator().manual_seed(3)
    real = tile.one_hot(torch.randint(0, 8, (5, 16, 16), generator=gen), 8)
    fake = torch.softmax(torch.randn(5, 16, 16, 8, generator=gen), -1)
    eps = torch.rand(5, 1, 1, 1, generator=gen)
    torch.testing.assert_close(critic(real), tile.critic_score(w, real, m),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(gradient_penalty(critic, real, fake, None, eps),
                               tile.gradient_penalty(w, real, fake, eps, m),
                               rtol=1e-5, atol=1e-5)


def _assert_same_draws(got, ref):
    if isinstance(got, dict):
        assert set(got) == set(ref)
        for k in got:
            _assert_same_draws(got[k], ref[k])
    elif isinstance(got, (list, tuple)):
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            _assert_same_draws(a, b)
    else:
        assert torch.equal(got, ref)


def test_wgan_gp_steps_match_port():
    from levelgan_torch import api
    from levelgan_torch.models import Critic, Generator
    from levelgan_torch.train.state import create_state
    cfg = _tile_cfg(**{"train.batch_size": 4, "train.seed": 2 ** 62 + 7})
    m, t = dataclasses.asdict(cfg.model), dataclasses.asdict(cfg.train)
    w_g = _weights(params.tile_generator(m), 13, inputs.WEIGHTS_G)
    w_d = _weights(params.tile_critic(m), 13, inputs.WEIGHTS_D)
    gen, critic = Generator(cfg.model), Critic(cfg.model)
    gen.load_state_dict(w_g)
    critic.load_state_dict(w_d)
    state = create_state(cfg, "cpu", generator=gen, critic=critic)
    corpus = inputs.tile_corpus(13, 32, 16, 8, "cpu")
    step_fn = api.make_step_fn(cfg)
    ref = tile.WganGp(w_g, w_d, m, t)
    for i in range(2):
        batch, noise = api.step_inputs(cfg, corpus, i, "cpu")
        ref_batch, ref_noise = draws.wgan_gp_step(corpus, cfg.train.seed, i,
                                                  m, t)
        assert torch.equal(batch, ref_batch)
        _assert_same_draws(noise, ref_noise)
        with api.step_mode():
            state, met = step_fn(state, batch, noise=noise)
        r = ref.step(ref_batch, ref_noise)
        assert float(met["d_loss"]) == pytest.approx(r["d_loss"], rel=1e-4)
        assert float(met["g_loss"]) == pytest.approx(r["g_loss"], rel=1e-4,
                                                     abs=1e-6)
    for k, p in state.generator.named_parameters():
        torch.testing.assert_close(p.detach(), ref.g[k].detach(), rtol=1e-4,
                                   atol=1e-6)
    for k, p in state.critic.named_parameters():
        torch.testing.assert_close(p.detach(), ref.d[k].detach(), rtol=1e-4,
                                   atol=1e-6)
    for k, p in state.g_ema.named_parameters():
        torch.testing.assert_close(p.detach(), ref.ema[k], rtol=1e-4,
                                   atol=1e-6)


def test_fp8_control_rounds_and_passes_gradient():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    y = precision.fp8(x)
    err = (y - x).detach().abs()
    assert float(err.max()) > 0
    # e4m3 keeps 3 bits of mantissa: a relative error of at most 2^-4
    assert bool((err <= 2.0 ** -4 * x.abs() + 1e-6).all())
    (y * torch.linspace(0.1, 1.0, 101)).sum().backward()
    g = torch.linspace(0.1, 1.0, 101)
    assert 0 < float((x.grad - g).abs().max()) <= 2.0 ** -3 * 1.0
