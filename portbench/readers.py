"""What the per-layer metric files (``metrics/<name>.py``) read.

Each takes the run's record (``drivers/*.py``: ``platform``, ``model``,
``traffic``, ``batch``, ``window_s``, ``units`` (batches or steps) and
``flops_per_unit`` of the window, ``stretch`` the profiled stretch, whose
``units`` count the same) and returns a number, or
``None`` when there is nothing to read (no card, no trace, no matching
kernel): the harness then leaves the metric out.
"""

from __future__ import annotations

from portbench import counts


def mfu(rec):
    """The window's model operations against one H100's bf16 peak, in
    percent (host clock, the window before any profiled stretch)."""
    if rec["platform"] != "cuda" or rec["window_s"] <= 0:
        return None
    return (100.0 * rec["units"] * rec["flops_per_unit"] / rec["window_s"]
            / counts.PEAK_BF16_FLOPS)


def idle_share(rec):
    """Share of the window (unprofiled) in which the device ran no kernel,
    copy or memset, in percent: the device's busy time a batch (step),
    read in the profiled stretch, times the window's batches (steps), over
    the window's time.  The profiler slows the host and not the device, so
    the stretch's own idle share would read high."""
    st = rec["stretch"]
    if st is None or st.busy_s <= 0 or not st.units or rec["window_s"] <= 0:
        return None
    busy_s = st.busy_s / st.units * rec["units"]
    return 100.0 * (1.0 - busy_s / rec["window_s"])


def device_ops_per_unit(rec):
    """Device operations (kernels, copies, memsets) in the profiled
    stretch over its batches (steps)."""
    st = rec["stretch"]
    if st is None or st.device_ops == 0 or not st.units:
        return None
    return st.device_ops / st.units


def host_syncs_per_unit(rec):
    """Host-blocking CUDA synchronisations (``trace.SYNC_NAMES``) in the
    profiled stretch over its batches (steps)."""
    st = rec["stretch"]
    if st is None or st.device_ops == 0 or not st.units:
        return None
    return st.syncs / st.units


def _stage_split(rec):
    stages = counts.stages(rec["model"], rec["batch"])
    return ([s for s in stages if counts.k1_stage(*s[1:3])],
            [s for s in stages if not counts.k1_stage(*s[1:3])])


def export_kernels_roofline(rec):
    """The port's stage kernels on the export path (K1 forward on the
    stages with at most 256 input positions, the K1L stage kernel on the
    others): the sum of each call's bound over their device time, %."""
    st = rec["stretch"]
    if st is None or rec["model"]["family"] != "tile":
        return None
    k1, k1l = _stage_split(rec)
    return counts.kernel_roofline(st.by_name, [
        ("upsample_block_fwd_kernel", [counts.k1_fwd(*s) for s in k1]),
        ("upsample_rows_stage_kernel", [counts.k1_fwd(*s) for s in k1l])])


def train_kernels_roofline(rec):
    """The port's kernels in a WGAN-GP step (K1 forward and its two
    backward passes, the K1L stage and its backward, the K2 core's norm
    penalty forward and backward) at the step's batch, %."""
    st = rec["stretch"]
    if st is None:
        return None
    m, b = rec["model"], rec["batch"]
    k1, k1l = _stage_split(rec)
    f = m["level_size"] ** 2 * m["n_tiles"]
    return counts.kernel_roofline(st.by_name, [
        ("upsample_block_fwd_kernel", [counts.k1_fwd(*s) for s in k1]),
        ("k1_bwd_gn_kernel", [counts.k1_bwd_gn(*s) for s in k1]),
        ("dx_gather_kernel", [counts.k1_bwd_dx(*s) for s in k1]),
        ("upsample_rows_stage_kernel", [counts.k1_fwd(*s) for s in k1l]),
        ("upsample_rows_bwd_kernel", [counts.k1l_bwd(*s) for s in k1l]),
        ("upsample_rows_bwd_general_kernel",
         [counts.k1l_bwd(*s) for s in k1l]),
        ("norm_penalty_fwd_kernel", [counts.k2_core_fwd(b, f)]),
        ("norm_penalty_bwd_kernel", [counts.k2_core_bwd(b, f)])])
