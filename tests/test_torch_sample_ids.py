"""The export's fused Gumbel head (``kernels/sample_ids.py``) on the CPU:
its plain version against ``decode(sample_head(...))`` over tile counts,
temperatures and crafted ties, the routing of ``models.sample_ids``, the
wrapper's refusals and the benchmark's reader of its launch counter.  The
kernel itself is held to the plain version on the card
(``tests/test_torch_cuda.py``)."""

import collections
import types

import numpy as np
import pytest
import torch

from levelgan_torch import obs
from levelgan_torch.config import preset
from levelgan_torch.data.codec import decode
from levelgan_torch.export import generate, generate_batch
from levelgan_torch.kernels import sample_ids as k
from levelgan_torch.models import Generator, sample_head, sample_ids
from levelgan_torch.models.heads import fused_head
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = preset("gumbel_64").override(**{
    "model.level_size": 16, "model.base_channels": 16,
    "model.critic_base_channels": 16, "model.group_size": 8,
    "model.dtype": "float32"})
TILES = [2, 5, 8, 16, 32]
TAUS = [0.5, 0.7]             # 1 / 0.7 is not exact in f32
TINY_F32 = float(np.finfo(np.float32).tiny)


def _gumbel(u):
    return -torch.log(-torch.log(u.clamp_min(TINY_F32)))


def _tied_rows(t):
    """[6, t] logits and uniforms whose ids rounding decides: all channels
    equal; perturbed logits one ulp apart near 0.1 (u = e^-1, so g is 0 to
    within an ulp; exp then rounds them to one value), the larger ones
    last; u = 0 beside u = FLT_MIN; u just under 1."""
    near = np.float32(0.1)
    up = np.nextafter(near, np.float32(1))
    u_e = np.float32(np.exp(-1.0))
    logits = np.zeros((6, t), np.float32)
    u = np.full((6, t), 0.5, np.float32)
    logits[0] = 0.75
    logits[1:3] = near
    logits[1, -1] = up
    logits[2, t // 2:] = up
    u[1:3] = u_e
    u[3, ::2] = 0.0
    u[3, 1::2] = TINY_F32
    u[4, 0], u[4, -1] = 0.0, TINY_F32
    u[5] = np.nextafter(np.float32(1), np.float32(0))
    return torch.from_numpy(logits), torch.from_numpy(u)


def _inputs(t, seed):
    g = torch.Generator().manual_seed(seed)
    logits = 3.0 * torch.randn((3, 5, 7, t), generator=g)
    u = torch.rand((3, 5, 7, t), generator=g)
    tl, tu = _tied_rows(t)
    return (torch.cat([logits.reshape(-1, t), tl]),
            torch.cat([u.reshape(-1, t), tu]))


@pytest.mark.parametrize("tau", TAUS)
@pytest.mark.parametrize("t", TILES)
def test_plain_version_is_the_heads_chain(t, tau):
    logits, u = _inputs(t, seed=t)
    want = decode(sample_head(logits, "gumbel", tau, noise=_gumbel(u)))
    assert torch.equal(k.gumbel_ids_plain(logits, u, tau), want)
    n = obs.counters["head.launches"]
    assert torch.equal(k.gumbel_ids(logits, u, tau), want)
    assert obs.counters["head.launches"] == n      # no launch on the CPU


def test_a_tie_after_rounding_goes_to_the_first_index():
    """Rows 1 and 2 of the crafted rows at tau 0.5: the last channels'
    perturbed logits are the largest, yet the id is 0, because every
    channel's softmax rounds to one value; so the kernel has to compute the
    softmax and not only an argmax of the perturbed logits."""
    logits, u = _tied_rows(8)
    v = (logits + _gumbel(u)) / 0.5
    assert [int(i) for i in torch.argmax(v[1:3], dim=-1)] == [7, 4]
    assert k.gumbel_ids_plain(logits, u, 0.5)[1:3].tolist() == [0, 0]


def test_inv_tau_is_the_f32_reciprocal():
    assert k.inv_tau(0.5) == 2.0
    assert k.inv_tau(0.7) == float(np.float32(1) / np.float32(0.7))
    assert k.inv_tau(0.7) != 1 / 0.7


def _stand_in(t=8, cuda=True, dtype=torch.float32):
    return types.SimpleNamespace(is_cuda=cuda, dtype=dtype,
                                 shape=(2, 4, 4, t))


def test_the_kernel_path_is_read_from_the_inputs():
    assert fused_head(_stand_in(), "gumbel")
    assert fused_head(_stand_in(32), "gumbel")
    for case in (dict(logits=_stand_in(), head="softmax"),
                 dict(logits=_stand_in(), head="argmax"),
                 dict(logits=_stand_in(), head="gumbel",
                      structural="spatial"),
                 dict(logits=_stand_in(), head="gumbel",
                      noise=torch.zeros(2, 4, 4, 8)),
                 dict(logits=_stand_in(), head="gumbel", plain=True),
                 dict(logits=_stand_in(cuda=False), head="gumbel"),
                 dict(logits=_stand_in(33), head="gumbel"),
                 dict(logits=_stand_in(dtype=torch.bfloat16),
                      head="gumbel")):
        assert not fused_head(**case), case


@pytest.mark.parametrize("head,structural,injected,plain", [
    ("gumbel", "none", False, False), ("gumbel", "spatial", False, False),
    ("gumbel", "none", True, False), ("gumbel", "none", False, True),
    ("softmax", "none", False, False), ("argmax", "none", False, False)])
def test_sample_ids_is_decode_of_sample_head(head, structural, injected,
                                             plain):
    logits = 2.0 * torch.randn((3, 6, 6, 8),
                               generator=torch.Generator().manual_seed(3))
    noise = _gumbel(torch.rand(logits.shape)) if injected else None

    def draw():
        return torch.Generator().manual_seed(11)

    n = obs.counters["head.launches"]
    got = sample_ids(logits, head, 0.5, structural, noise=noise,
                     generator=draw(), plain=plain)
    want = decode(sample_head(logits, head, 0.5, structural, noise=noise,
                              generator=draw()))
    assert got.dtype == torch.uint8 and torch.equal(got, want)
    assert obs.counters["head.launches"] == n


@pytest.mark.parametrize("structural", ["none", "spatial"])
def test_export_draws_as_before(structural):
    """``generate`` draws z and then the head's uniforms from one generator
    seeded by ``seed``, batch by batch, as ``decode(sample_head(...))``
    drew them; with ``plain=True`` too."""
    cfg = TINY.override(**{"model.structural_head": structural})
    gen = Generator(cfg.model).init_params(torch.Generator().manual_seed(0))
    levels = generate(cfg, gen, 12, seed=5, batch_size=5, device="cpu")
    rng = torch.Generator().manual_seed(5)
    want, plain = [], []
    with torch.inference_mode():
        for lo in range(0, 12, 5):
            z = torch.randn((5, cfg.model.latent_dim), generator=rng)
            state = rng.get_state()
            want.append(decode(sample_head(gen(z), "gumbel",
                                           cfg.model.tau_end, structural,
                                           generator=rng)))
            rng.set_state(state)
            plain.append(generate_batch(gen, cfg, z, generator=rng,
                                        plain=True))
    assert np.array_equal(levels, torch.cat(want)[:12].numpy())
    assert torch.equal(torch.cat(plain), torch.cat(want))


@pytest.mark.parametrize("case", ["noncontiguous", "f64", "bf16", "u_shape",
                                  "too_many_tiles"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(case):
    logits = torch.randn(4, 6, 8)
    u = torch.rand(4, 6, 8)
    if case == "noncontiguous":
        logits = torch.randn(4, 8, 6).transpose(1, 2)
    elif case == "f64":
        logits = logits.double()
    elif case == "bf16":
        u = u.bfloat16()
    elif case == "u_shape":
        u = u[:, :5]
    else:
        logits, u = torch.randn(4, 33), torch.rand(4, 33)
    with pytest.raises(ValueError):
        k.gumbel_ids(logits, u, 0.5)


def test_the_benchmarks_reader_counts_launches_per_request(monkeypatch):
    from portbench import harness
    read = harness.metric_reader("fused_heads_per_request.export")
    stretch = types.SimpleNamespace(units=128)
    session = obs.Session(
        spans=[types.SimpleNamespace(name="export.request")] * 2,
        counters={"head.launches": 128})
    monkeypatch.setattr(obs, "last_session", lambda: session)
    monkeypatch.setattr(obs, "counters", collections.Counter())
    assert read({"stretch": stretch}) is None     # never counted: no kernel
    obs.count("head.launches", 0)
    assert read({"stretch": stretch}) == 64.0
    assert read({"stretch": None}) is None
