"""``levelgan_torch.obs``: spans only while a profiler records, the one
counter registry, the export's and the WGAN-GP step's span trees, the
benchmark's readers of them, and (on the card) the clock shared with the
device."""

import json
import math
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from levelgan_torch import api, obs
from levelgan_torch.config import preset
from levelgan_torch.export import generate
from levelgan_torch.models import Generator
from levelgan_torch.train.state import create_state
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = {"model.level_size": 16, "model.base_channels": 16,
        "model.critic_base_channels": 16, "model.group_size": 8,
        "model.dtype": "float32"}
READERS = {"gumbel_64.export": ["generator_ms_per_batch.export",
                                "head_ms_per_batch.export",
                                "weight_packs_per_request.export"],
           "gumbel_64.train_b512": ["critic_ms_per_step.train",
                                    "generator_update_ms_per_step.train",
                                    "optimizer_ms_per_step.train"]}


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _tree(session):
    """(depth, name) of each span in entry order."""
    return [(s.depth, s.name) for s in session.spans]


def test_off_a_span_records_nothing_and_counts_still_count():
    with _cpu_profile():
        with obs.span("before"):
            pass
    first = obs.last_session()
    assert _tree(first) == [(0, "before")]
    n = obs.counters["test.off"]
    assert obs.span("a") is obs.span("b", id=3, k=1)   # one null context
    with obs.span("a", id=1):
        with obs.span("b"):
            obs.count("test.off", 2)
    assert obs.counters["test.off"] == n + 2
    assert obs.last_session() is first


def test_on_spans_nest_under_their_root_and_the_counters_change_is_kept():
    obs.count("test.on", 5)                  # before the session: not in it
    with _cpu_profile():
        with obs.span("outer", id=7, n=2):
            obs.count("test.on")
            with obs.span("mid"):
                with obs.span("inner"):
                    obs.count("test.on", 2)
            with obs.span("mid"):
                pass
        with obs.span("second", id=8):
            pass
    obs.count("test.on", 100)                # after its last root: not in it
    s = obs.last_session()
    assert _tree(s) == [(0, "outer"), (1, "mid"), (2, "inner"), (1, "mid"),
                        (0, "second")]
    outer, mid, inner, mid2, second = s.spans
    assert (mid.parent, inner.parent, mid2.parent) == (0, 1, 0)
    assert outer.parent is None and second.parent is None
    assert [sp.id for sp in s.spans] == [7, 7, 7, 7, 8]
    assert [sp.root for sp in s.spans] == [0, 0, 0, 0, 4]
    assert outer.attrs == {"n": 2}
    assert s.counters == {"test.on": 3}
    for sp in s.spans:                       # the CPU: device = host
        assert sp.host_start <= sp.host_end
        assert sp.device_ns == sp.host_end - sp.host_start
    assert outer.host_start <= inner.host_start <= inner.host_end \
        <= outer.host_end


def test_a_session_ends_at_the_first_span_after_the_profiler_stops():
    with _cpu_profile():
        with obs.span("one"):
            pass
    with obs.span("off"):                    # ends the session
        pass
    with _cpu_profile():
        with obs.span("two"):
            pass
    assert _tree(obs.last_session()) == [(0, "two")]


def test_the_record_is_capped(monkeypatch):
    monkeypatch.setattr(obs, "SPAN_CAP", 3)
    with _cpu_profile():
        with obs.span("root", id=0):
            for _ in range(5):
                with obs.span("leaf"):
                    pass
    s = obs.last_session()
    assert len(s.spans) == 3 and s.dropped == 3


def test_the_profilers_trace_holds_the_spans_and_a_roots_id(tmp_path):
    with _cpu_profile() as prof:
        with obs.span("export.request", id=11):
            with obs.span("export.batch"):
                pass
    obs.last_session()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert {"export.request 11", "export.batch"} <= names


def test_export_records_one_request_its_build_and_each_batchs_layers():
    cfg = preset("toy_dcgan_16").override(**TINY)
    gen = Generator(cfg.model).init_params(torch.Generator().manual_seed(0))
    with _cpu_profile():
        levels = generate(cfg, gen.state_dict(), 12, seed=5, batch_size=4,
                          device="cpu")
    assert levels.shape == (12, 16, 16)
    s = obs.last_session()
    batch = [(1, "export.batch"), (2, "export.draw"),
             (2, "export.generator"), (2, "export.head"), (2, "export.put")]
    assert _tree(s) == ([(0, "export.request"), (1, "export.build")]
                        + 3 * batch + [(1, "export.drain")])
    root = s.spans[0]
    assert root.id == 5 and root.attrs == {"n": 12, "batch_size": 4}
    assert {sp.id for sp in s.spans} == {5}
    # the request and its build keep host times only, the rest device times
    for sp in s.spans:
        host_only = sp.name in ("export.request", "export.build")
        assert (sp.device_ns is None) == host_only, sp.name
    assert s.device_s("export.generator") is not None
    assert s.device_s("export.request") is None


def test_a_wgan_gp_step_records_n_critic_critics_and_n_critic_plus_one_adams():
    cfg = preset("wgan_gp_32").override(**TINY, **{
        "train.batch_size": 4, "train.n_critic": 3})
    state = create_state(cfg, "cpu")
    corpus = torch.randint(0, cfg.model.n_tiles, (16, 16, 16),
                           dtype=torch.uint8)
    step_fn = api.make_step_fn(cfg)
    with _cpu_profile():
        batch, noise = api.step_inputs(cfg, corpus, 0, "cpu")
        with api.step_mode():
            step_fn(state, batch, noise=noise)
    s = obs.last_session()
    critic = [(1, "train.critic"), (2, "critic.fake"), (2, "critic.loss"),
              (2, "critic.grad"), (2, "optim.adam")]
    assert _tree(s) == ([(0, "train.inputs"), (0, "train.step")] + 3 * critic
                        + [(1, "train.generator"), (2, "g.loss"),
                           (2, "g.grad"), (2, "optim.adam"),
                           (1, "train.ema")])
    assert len(s.named("optim.adam")) == cfg.train.n_critic + 1
    assert [sp.id for sp in s.spans if sp.parent is None] == [1, 1]
    assert state.step == 1


@pytest.mark.parametrize("workload", sorted(READERS))
def test_the_benchmarks_span_readers_read_a_cpu_rehearsal(workload):
    from portbench import harness
    traffic = ({"levels": 64, "batch": 16, "min_requests": 2}
               if workload.endswith("export") else
               {"batch": 8, "corpus": 64, "min_steps": 2})
    line = harness.run_cell(workload, 2 ** 31 + 2026, 0.2, True,
                            device="cpu", config_extra={
                                **TINY, "model.level_size": 64},
                            traffic_extra=traffic)
    assert line["correct"] is True
    for name in READERS[workload]:
        value = line["metrics"][name]["value"]
        assert math.isfinite(value) and value >= 0, name


def test_the_span_readers_read_nothing_without_a_session(monkeypatch):
    from portbench import harness
    monkeypatch.setattr(obs, "last_session", lambda: obs.Session())
    stretch = type("Stretch", (), {"units": 3})()
    for names in READERS.values():
        for name in names:
            read = harness.metric_reader(name)
            assert read({"stretch": stretch}) is None, name
            assert read({"stretch": None}) is None, name


@pytest.mark.cuda
def test_a_host_sleep_in_a_span_lies_in_the_traces_device_gap(tmp_path):
    """The spans' host and device times, and the profiler's trace, are on
    one clock: the stream reaches the span of a 5 ms host sleep, between
    two device sleeps, where the trace's first sleep ends, and the trace's
    idle gap after that sleep lies under the span as long as the host
    stays in it.  (The gap also holds the second sleep's launch after the
    span: the host's own latency, 0.54 ms once on the card, which is no
    clock's error.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the device's clock)")
    cycles = 2_000_000
    torch.cuda._sleep(cycles)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with obs.span("root", id=0):
            torch.cuda._sleep(cycles)
            with obs.span("host"):
                time.sleep(0.005)
            torch.cuda._sleep(cycles)
        torch.cuda.synchronize()
    s = obs.last_session()
    root, host = s.spans
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.load(open(path))
    base = trace["baseTimeNanoseconds"]
    sleeps = sorted((e for e in trace["traceEvents"]
                     if e.get("ph") == "X" and e.get("cat") == "kernel"),
                    key=lambda e: e["ts"])
    assert len(sleeps) == 2
    ms = 1e-6
    first_end = base + 1e3 * (sleeps[0]["ts"] + sleeps[0]["dur"])
    second_start = base + 1e3 * sleeps[1]["ts"]
    assert host.host_start < first_end < host.host_end < second_start
    # the stream reached the span's entry as the trace's first sleep ended,
    # so the span's own view of the idle under it is the trace's
    assert abs(host.device_start - first_end) * ms < 0.2
    assert (host.host_end - host.device_start) * ms > 3.5
    # stream order: the span's exit, then the second sleep
    assert host.device_end < second_start
    assert root.device_start <= host.device_start <= host.device_end \
        <= root.device_end
