"""The traced stretch of a run and its reduction to per-layer readings.

``profile`` drives ``n`` more calls of the closed loop under
``torch.profiler`` (CPU and CUDA activities, shapes recorded) inside one
``portbench.window`` span, and meanwhile records every hand-kernel
launch the program makes (its name and C arguments, through the
program's one launch function) and the program's ``LAUNCHES`` counters
before and after.

Device operations are sorted into three classes:

* hand kernels: the kernel's name, less ``void``, its template and
  ``_kernel``, begins with a launch name of a ``LAUNCHES`` counter
  (``fold_tw_kernel<false>`` -> ``fold_tw``);
* GEMMs: kernels the profiler ties to ``aten::_int_mm`` (or another
  matrix-product op);
* torch ops: PyTorch's own kernels (``at::`` and its CUB instances),
  copies and fills.

A kernel of none of these classes is logged with its time and counted
in no layer's metric.  Each launch name's launches are logged against
the kernels the profiler recorded for it, equal or not.
"""

from __future__ import annotations

import bisect
import json
import re
import sys
from dataclasses import dataclass, field

import torch

from .harness import BENCH, PROGRAM, log

GEMM_OPS = ("aten::_int_mm", "aten::mm", "aten::addmm", "aten::bmm",
            "aten::matmul")


def peaks_for(kind: str) -> dict | None:
    table = json.loads((BENCH / "peaks.json").read_text())
    peaks = table["devices"].get(kind)
    if peaks is None:
        log(f"no peaks for device {kind!r} in peaks.json: rooflines left out")
    return peaks


def launch_counters() -> dict:
    """Every ``LAUNCHES`` counter of the program's loaded modules."""
    out = {}
    for name, mod in list(sys.modules.items()):
        if name.split(".")[0] != PROGRAM:
            continue
        counts = getattr(mod, "LAUNCHES", None)
        if isinstance(counts, dict):
            out.update(counts)
    return out


def kernel_base(name: str) -> str:
    """``void (anonymous namespace)::fold_tw_kernel<false>(...)`` ->
    ``fold_tw``: the unqualified name less its template, arguments and
    ``_kernel``."""
    base = name[5:] if name.startswith("void ") else name
    base = base.replace("(anonymous namespace)::", "")
    base = re.split(r"[<(]", base, maxsplit=1)[0].strip().split("::")[-1]
    return base[:-7] if base.endswith("_kernel") else base


def short_name(name: str, limit: int = 160) -> str:
    return name if len(name) <= limit else name[:limit - 3] + "..."


@dataclass
class TraceSummary:
    calls: int
    window_s: float
    busy_s: float
    device_ops: dict                     # short name -> seconds
    hand: dict                           # launch name -> [seen, seconds]
    torch_s: float
    gemm: list                           # (input shapes, seconds)
    launches: list                       # (launch name, C args)
    launch_counts: dict                  # launch name -> count (LAUNCHES)
    idle: dict = field(default_factory=dict)   # host label -> seconds

    def breakdown(self) -> dict:
        ops = sorted(self.device_ops.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


TORCH_MARKS = ("at::", "at_cuda_detail::", "cub::")


def is_torch_kernel(name: str) -> bool:
    return (name.startswith(("Memcpy", "Memset"))
            or any(m in name for m in TORCH_MARKS))


def _hand_name(name: str, names) -> str | None:
    """The launch name of a hand kernel's device name, or None.  PyTorch's
    own kernels (``at::``) never match."""
    if "at::" in name:
        return None
    base, best = kernel_base(name), None
    for n in names:
        if base.startswith(n) and (best is None or len(n) > len(best)):
            best = n
    return best


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _host_label(cpu, starts, t):
    """The innermost host op running at time t (latest start that
    still covers t), or ``python`` when none is."""
    i = bisect.bisect_right(starts, t) - 1
    steps = 0
    while i >= 0 and steps < 10000:
        s, e, name = cpu[i]
        if e >= t:
            return name
        i -= 1
        steps += 1
    return "python"


def profile(one_call, start: int, n: int, device) -> TraceSummary:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    from torch.profiler import record_function

    build = sys.modules.get(PROGRAM + ".ops._build")
    launches = []
    original = build.launch if build is not None else None

    def recording(counts, name, fn, dev, *args, stream=None):
        launches.append((name, args))
        return original(counts, name, fn, dev, *args, stream=stream)

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    before = launch_counters()
    if build is not None:
        build.launch = recording
    try:
        with tprofile(activities=activities, record_shapes=True) as prof:
            with record_function("portbench.window"):
                for i in range(start, start + n):
                    one_call(i)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    finally:
        if build is not None:
            build.launch = original
    after = launch_counters()
    counts = {k: after[k] - before.get(k, 0) for k in after
              if after[k] != before.get(k, 0)}

    events = prof.events()
    window = [e for e in events if e.name == "portbench.window"
              and e.device_type == DeviceType.CPU]
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    # device operations, less the device-side copies of the spans
    dev_events = [e for e in events if e.device_type != DeviceType.CPU
                  and not e.name.startswith("portbench.")
                  and e.time_range.end > w0 and e.time_range.start < w1]
    gemm_names, gemm = set(), []
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in GEMM_OPS:
            ks = list(e.kernels)
            gemm_names.update(k.name for k in ks)
            if ks:
                gemm.append((e.input_shapes,
                             sum(k.duration for k in ks) * 1e-6))
    launch_names = set(after)
    ops, hand, torch_s = {}, {}, 0.0
    by_class = {"hand": set(), "gemm": set(), "torch": set()}
    other = {}
    for e in dev_events:
        s = (e.time_range.end - e.time_range.start) * 1e-6
        sn = short_name(e.name)
        ops[sn] = ops.get(sn, 0.0) + s
        h = None if e.name in gemm_names else _hand_name(e.name,
                                                         launch_names)
        if e.name in gemm_names:
            by_class["gemm"].add(sn)
        elif h is not None:
            by_class["hand"].add(sn)
            seen = hand.setdefault(h, [0, 0.0])
            seen[0] += 1
            seen[1] += s
        elif is_torch_kernel(e.name):
            by_class["torch"].add(sn)
            torch_s += s
        else:
            other[sn] = other.get(sn, 0.0) + s
    for cls, names in by_class.items():
        log(f"trace: {len(names)} {cls} kernel names, e.g. "
            f"{[n[:100] for n in sorted(names)[:6]]}")
    for sn, s in sorted(other.items(), key=lambda kv: -kv[1]):
        log(f"trace: kernel of no class, {s:.9f} s, in no layer's "
            f"metric: {sn}")
    for h in sorted(set(counts) | set(hand)):
        log(f"trace: {h} launched {counts.get(h, 0)} times, the profiler "
            f"recorded {hand.get(h, [0])[0]}")

    busy = _merge([(max(e.time_range.start, w0), min(e.time_range.end, w1))
                   for e in dev_events])
    busy_s = sum(e - s for s, e in busy) * 1e-6
    cpu = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in events if e.device_type == DeviceType.CPU
                 and e.name != "portbench.window")
    starts = [c[0] for c in cpu]
    idle = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for s, e in zip(edges[::2], edges[1::2]):
        if e > s:
            label = short_name(_host_label(cpu, starts, (s + e) / 2))
            idle[label] = idle.get(label, 0.0) + (e - s) * 1e-6
    return TraceSummary(n, (w1 - w0) * 1e-6, busy_s, ops, hand, torch_s,
                        gemm, launches, counts, idle)
