"""A profiled stretch of a run, reduced to what the per-layer metrics read.

``profiled(fn)`` runs ``fn`` under ``torch.profiler`` (the device and the
CUDA runtime calls), writes the Chrome trace to a temporary directory
(``TMPDIR``), and reduces it: the stretch's time, the union of the
device's activity in it (kernels, copies, memsets), device operations by
name, the idle gaps between them named by the host event (a runtime
call) that overlaps each most, and the host-blocking synchronisations.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import tempfile

import numpy as np

STRETCH = "portbench.stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver", "cpu_op")
SYNC_NAMES = ("cudaStreamSynchronize", "cudaEventSynchronize",
              "cudaDeviceSynchronize", "cudaMemcpy")
TOP = 10
NAMED_GAP_US = 10.0      # shorter gaps are launch spacing, not named
SPACING = "launch spacing (gaps under 10 us)"


@dataclasses.dataclass
class Stretch:
    window_s: float                      # host time of the annotated stretch
    busy_s: float                        # union of device activity in it
    device_ops: int                      # kernels, copies and memsets
    syncs: int                           # host-blocking synchronisations
    by_name: dict                        # device op name -> [count, seconds]
    idle_gaps: list                      # [[host event, seconds]] longest
    units: float = 0.0                   # batches or steps in the stretch

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def top_ops(self) -> list:
        rows = sorted(self.by_name.items(), key=lambda kv: -kv[1][1])[:TOP]
        return [[name, secs] for name, (_, secs) in rows]


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_events(events: list) -> Stretch:
    """Reduce Chrome-trace events (ts / dur in microseconds) to a Stretch
    over the ``STRETCH`` annotation's time."""
    marks = [e for e in events if e.get("name") == STRETCH
             and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    if marks:
        lo = marks[0]["ts"]
        hi = lo + marks[0]["dur"]
    else:   # device activity only: from the first CUDA call to the last end
        calls = [e["ts"] for e in spans if e.get("cat") == "cuda_runtime"]
        if not calls:
            raise RuntimeError("the trace holds no CUDA runtime call")
        lo = min(calls)
        hi = max(e["ts"] + e["dur"] for e in spans)
    dev, host, syncs = [], [], 0
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, b = e["ts"], e["ts"] + e["dur"]
        if b <= lo or a >= hi:
            continue
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            dev.append((max(a, lo), min(b, hi)))
            row = by_name[e["name"]]
            row[0] += 1
            row[1] += e["dur"] * 1e-6
        elif cat in HOST_CATS:
            host.append((a, b, e["name"]))
            if cat == "cuda_runtime" and e["name"] in SYNC_NAMES:
                syncs += 1
    busy = _merge(dev)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = collections.defaultdict(float)
    ha = np.array([h[0] for h in host], np.float64)
    hb = np.array([h[1] for h in host], np.float64)
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        name = SPACING
        if b - a >= NAMED_GAP_US:
            name = "host work between CUDA calls"
            if len(host):
                ov = np.minimum(b, hb) - np.maximum(a, ha)
                k = int(np.argmax(ov))
                if ov[k] > 0:
                    name = host[k][2]
        gaps[name] += (b - a) * 1e-6
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return Stretch(window_s=(hi - lo) * 1e-6,
                   busy_s=sum(b - a for a, b in busy) * 1e-6,
                   device_ops=len(dev), syncs=syncs, by_name=dict(by_name),
                   idle_gaps=[[k, v] for k, v in top_gaps])


def profiled(fn, cuda: bool = True) -> tuple[object, Stretch]:
    """(fn's result, its Stretch): ``fn`` runs under the profiler and must
    end with the device synchronised.  On the card only the device and the
    CUDA runtime calls are recorded (recording the host's ATen operators
    too slowed a train step from 265 to 388 ms and so raised the idle share
    it read); the stretch runs from the first CUDA call to the last event's
    end.  ``cuda=False``: host activity only, for rehearsals on the CPU,
    inside the ``STRETCH`` annotation."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        with record_function(STRETCH):
            out = fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    del prof
    if cuda:
        torch.cuda.synchronize()
    return out, reduce_events(events)
