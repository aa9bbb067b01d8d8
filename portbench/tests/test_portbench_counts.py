"""The work counts reproduce PERF.md's bounds, and the share readers give
needed work over measured time."""

import pytest
import torch

from portbench import counts, trace

G64 = dict(level_size=64, base_channels=64, max_channels=512, n_tiles=8,
           latent_dim=64, critic_base_channels=64, cond_dim=0)


def _ms(fb):
    return 1e3 * counts.bound_s(*fb)


def test_k1_forward_bound_at_gumbel_64_export():
    stages = counts.stages(G64, 1024)
    assert [s[1:] for s in stages] == [(4, 4, 512, 256), (8, 8, 256, 128),
                                       (16, 16, 128, 64), (32, 32, 64, 32)]
    for s in stages[:3]:
        assert counts.k1_stage(s[1], s[2])
        assert _ms(counts.k1_fwd(*s)) == pytest.approx(0.0695, abs=5e-5)
        assert counts.bound_by(*counts.k1_fwd(*s)) == "operations"
        assert counts.stage_flops(*s) / 1024 == pytest.approx(67.1e6, rel=1e-3)


def test_k1l_stage_bound_is_bytes():
    s = counts.stages(G64, 1024)[3]
    assert not counts.k1_stage(s[1], s[2])
    assert _ms(counts.k1_fwd(*s)) == pytest.approx(0.1202, abs=5e-5)
    assert counts.bound_by(*counts.k1_fwd(*s)) == "bytes"


def test_k2_core_bounds_at_64_by_32768():
    assert _ms(counts.k2_core_fwd(64, 32768)) == pytest.approx(0.00250,
                                                               abs=5e-6)
    assert _ms(counts.k2_core_bwd(64, 32768)) == pytest.approx(0.00501,
                                                               abs=5e-6)


def test_model_work():
    assert counts.generator_flops(G64) == pytest.approx(0.2884e9, rel=1e-3)
    step = counts.wgan_gp_step_flops(G64, 5)
    assert 15e9 < step < 17e9          # ~16 GFLOP a sample


def test_kernel_roofline_is_needed_over_measured():
    s = counts.stages(G64, 1024)
    bound = counts.bound_s(*counts.k1_fwd(*s[0]))
    by_name = {"(anonymous namespace)::upsample_block_fwd_kernel(__nv_bfloat16"
               " const*, float const*)": [6, 20 * bound],
               "void upsample_block_fwd_kernel<4, 2>(Args)": [4, 20 * bound],
               "void at::native::elementwise_kernel<128>(int)": [5, 1.0]}
    share = counts.kernel_roofline(by_name, [
        ("upsample_block_fwd_kernel", [counts.k1_fwd(*x) for x in s[:3]])])
    assert share == pytest.approx(100 * 10 / 40)
    assert counts.kernel_roofline({}, [("upsample_block_fwd_kernel",
                                        [counts.k1_fwd(*s[0])])]) is None


def _reader(name):
    from portbench.harness import metric_reader
    return metric_reader(name)


def test_mfu_reader_gives_work_over_time_and_nothing_off_the_card():
    rec = {"platform": "cuda", "window_s": 2.0, "units": 1000,
           "flops_per_unit": 989e9, "stretch": None}
    assert _reader("mfu.export")(rec) == pytest.approx(100 * 1000 * 989e9
                                                       / 2.0 / 989e12)
    assert _reader("mfu.export")({**rec, "platform": "cpu"}) is None


def test_stretch_readers_from_chrome_events():
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.STRETCH,
           "ts": 0.0, "dur": 1000.0},
          {"ph": "X", "cat": "kernel", "name": "void upsample_block_fwd_kernel<1>()",
           "ts": 100.0, "dur": 200.0},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 250.0, "dur": 250.0},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
           "ts": 600.0, "dur": 300.0},
          {"ph": "X", "cat": "cpu_op", "name": "aten::randn", "ts": 520.0,
           "dur": 50.0}]
    st = trace.reduce_events(ev)
    st.units = 2
    assert st.window_s == pytest.approx(1e-3)
    assert st.busy_s == pytest.approx(400e-6)
    assert st.device_ops == 2 and st.syncs == 1
    gaps = dict(st.idle_gaps)        # each gap named by the host event
    assert gaps["cudaStreamSynchronize"] == pytest.approx(500e-6)
    assert gaps["host work between CUDA calls"] == pytest.approx(100e-6)
    # the idle share of the unprofiled window: 200 us of device time a
    # batch in the stretch, 10 batches in a 4 ms window
    rec = {"stretch": st, "platform": "cuda", "units": 10, "window_s": 4e-3}
    assert _reader("idle_share.export")(rec) == pytest.approx(50.0)
    assert _reader("device_ops_per_batch.export")(rec) == 1.0
    assert _reader("host_syncs_per_batch.export")(rec) == 0.5
    # without the host's annotation: from the first CUDA call to the end
    st = trace.reduce_events(ev[1:] + [{"ph": "X", "cat": "cuda_runtime",
                                        "name": "cudaLaunchKernel",
                                        "ts": 90.0, "dur": 5.0}])
    assert st.window_s == pytest.approx(810e-6)
    assert st.busy_s == pytest.approx(400e-6)


@pytest.mark.cuda
def test_profiled_stretch_sees_device_time(cuda):
    a = torch.randn(2048, 2048, device=cuda)

    def work():
        for _ in range(10):
            a @ a
        torch.cuda.synchronize()
    _, st = trace.profiled(work)
    assert st.device_ops >= 10 and 0 < st.busy_s <= st.window_s
