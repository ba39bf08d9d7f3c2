"""The program's spans in a traced stretch of one cell, and what they
attribute.

    python3 portbench/spans.py --workload <cell> --seed <n>

From the root of a checkout, as ``run.py``.  The cell's entry is built
and warmed up as a run builds it (``harness``); 60 calls are timed on
the host clock, then as many more as the traffic's ``trace_calls`` run
under ``torch.profiler`` (CPU and CUDA activities, shapes recorded, each
call in a ``portbench.call`` span), as a traced run makes them.  Logs the
span table and prints one JSON line: the host ms a call untraced and
traced, the span table and the readings below.  No comparison with the
reference: ``run.py`` decides ``correct``.

A program span is a CPU event named ``<layer>.<stage>`` for the layers
``fold``, ``model``, ``mxu`` and ``digits`` (``utils/trace.py`` of the
program); an outermost one is a call span.  A kernel belongs to the
innermost program span above the host event the profiler ties it to
(the ``aten::`` op, or the runtime call of a hand kernel).  A device
event that bears the name of a host-side span of the window is that
span's device-side copy, not a kernel, and is dropped.

Readings, each a traced call's mean:

* ``slot_product_ms``: device ms of the kernels under
  ``model.slot_product``;
* ``digit_prep_ms``: device ms of the kernels under ``digits.planes`` or
  ``digits.offsets``;
* ``port_py_ms``: host ms inside call spans that no ``aten::`` op and no
  CUDA runtime call covers: the program's own Python;
* ``ops_per_call``: outermost ``aten::`` ops under call spans.

With a program that has no spans, every reading is left out.
"""

from __future__ import annotations

import re
import statistics
import sys
import time

import torch

PROGRAM_SPAN = re.compile(r"^(fold|model|mxu|digits)\.[a-z0-9_]+$")
READINGS = {"slot_product_ms": ("model.slot_product",),
            "digit_prep_ms": ("digits.planes", "digits.offsets")}


def is_program_span(name: str) -> bool:
    return PROGRAM_SPAN.match(name) is not None


def _is_runtime(name: str) -> bool:
    return name.startswith(("cuda", "cu")) and "::" not in name


def _merged_length(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _dur(e) -> float:
    return e.time_range.end - e.time_range.start


def reduce(events, calls: int) -> dict:
    """The span table and readings of a traced stretch of ``calls``
    calls from the profiler's events (``prof.events()``: ``name``,
    ``device_type``, ``time_range``, ``cpu_parent``, ``id``,
    ``kernels``), in ms a call."""
    from torch.autograd import DeviceType

    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    program = {e.name for e in cpu if is_program_span(e.name)}
    host_spans = program | {e.name for e in cpu
                            if e.name.startswith("portbench.")}
    device = [e for e in events if e.device_type != DeviceType.CPU]
    copies = sum(e.name in program for e in device)
    device_us = sum(_dur(e) for e in device if e.name not in host_spans)

    # each event's innermost program span, call span, and whether an
    # aten:: op lies between it and its call span
    up: dict = {}

    def lineage(e):
        key = id(e)
        if key not in up:
            p = e.cpu_parent
            if p is None:
                up[key] = (None, None, False)
            else:
                inner, call, aten = lineage(p)
                if is_program_span(p.name):
                    inner = p
                    call = call or p
                up[key] = (inner, call,
                           aten or (p.name.startswith("aten::")
                                    and call is not None
                                    and not is_program_span(p.name)))
        return up[key]

    table: dict = {}

    def row(name):
        return table.setdefault(name, {"count": 0, "device_us": 0.0,
                                       "host_self_us": 0.0})

    children: dict = {}
    kernel_ids, spanned_us, tied_us, ops = set(), 0.0, 0.0, 0
    covered: dict = {}                   # call span -> covered intervals
    for e in cpu:
        inner, call, aten_above = lineage(e)
        if is_program_span(e.name):
            row(e.name)["count"] += 1
            children.setdefault(id(inner), []).append(e)
            inner = e
            call = call or e
        elif call is not None and (e.name.startswith("aten::")
                                   or _is_runtime(e.name)):
            covered.setdefault(id(call), []).append(
                (e.time_range.start, e.time_range.end))
            ops += e.name.startswith("aten::") and not aten_above
        if e.kernels and e.id not in kernel_ids:
            kernel_ids.add(e.id)
            us = sum(k.duration for k in e.kernels
                     if k.name not in host_spans)
            tied_us += us
            if inner is not None:
                spanned_us += us
                row(inner.name)["device_us"] += us
    py_us = 0.0
    for e in cpu:
        if not is_program_span(e.name):
            continue
        kids = [(k.time_range.start, k.time_range.end)
                for k in children.get(id(e), [])]
        row(e.name)["host_self_us"] += _dur(e) - _merged_length(kids)
        if lineage(e)[1] is None:        # a call span
            py_us += _dur(e) - _merged_length(covered.get(id(e), []))
    per = 1e-3 / max(calls, 1)
    out = {
        "calls": calls,
        "copies_dropped": copies,
        "device_ms": device_us * per,
        "tied_ms": tied_us * per,
        "unspanned_share": (1.0 - spanned_us / tied_us) if tied_us else None,
        "spans": {n: {"count": r["count"] / max(calls, 1),
                      "device_ms": r["device_us"] * per,
                      "host_self_ms": r["host_self_us"] * per}
                  for n, r in sorted(table.items())},
        "readings": {},
    }
    if table:
        for key, names in READINGS.items():
            if any(n in table for n in names):
                out["readings"][key] = sum(table[n]["device_us"]
                                           for n in names if n in table) * per
        out["readings"]["port_py_ms"] = py_us * per
        out["readings"]["ops_per_call"] = ops / max(calls, 1)
    return out


def log_table(summary: dict, log) -> None:
    log(f"spans: {summary['calls']} traced calls; device ms a call "
        f"{summary['device_ms']:.6f}, tied to a host event "
        f"{summary['tied_ms']:.6f}; share under no program span "
        f"{summary['unspanned_share']}; device-side span copies dropped "
        f"{summary['copies_dropped']}")
    log(f"spans: {'span':<20} {'a call':>7} {'device ms':>11} "
        f"{'host self ms':>13}")
    for name, r in summary["spans"].items():
        log(f"spans: {name:<20} {r['count']:>7.2f} {r['device_ms']:>11.6f} "
            f"{r['host_self_ms']:>13.6f}")
    for key, value in summary["readings"].items():
        log(f"spans: {key} {value:.6f}")


def trace_cell(cell_name: str, seed: int, untraced: int = 60,
               calls: int | None = None, device: str = "cuda",
               overrides: dict | None = None) -> dict:
    """Build, warm up and time one cell's entry as ``harness.run`` does,
    then trace ``calls`` calls (the traffic's ``trace_calls`` by
    default); the JSON line's object."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    from portbench import harness

    c = harness.cell(cell_name, overrides)
    dev = torch.device(device)
    entry_mod = harness.load_module(harness.BENCH / "entries"
                                    / f"{c.traffic['entry']}.py")
    entry = entry_mod.Entry(c.config, c.traffic, seed, dev, "program")
    if calls is None:
        calls = int(c.traffic["trace_calls"])

    def one_call(index, span=None):
        inputs = entry.next_inputs(index)
        t0 = time.perf_counter()
        if span is None:
            outputs = entry.call(inputs)
        else:
            with span("portbench.call"):
                outputs = entry.call(inputs)
        ms = (time.perf_counter() - t0) * 1e3
        entry.finish(outputs)
        entry.advance(outputs)
        return ms

    index = int(c.traffic["warmup_calls"])
    for i in range(index):
        one_call(i)
    host = [one_call(i) for i in range(index, index + untraced)]
    index += untraced
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, record_shapes=True) as prof:
        traced = [one_call(i, record_function)
                  for i in range(index, index + calls)]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    summary = reduce(prof.events(), calls)
    log_table(summary, harness.log)
    entry.release()
    return {
        "cell": cell_name,
        "seed": seed,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "power_limit": harness.power_limit() if dev.type == "cuda" else None,
        "host_ms_untraced": {"mean": statistics.fmean(host),
                             "median": statistics.median(host)}
        if host else None,
        "host_ms_traced": {"mean": statistics.fmean(traced),
                           "median": statistics.median(traced)},
        **summary,
    }


def main(argv=None) -> int:
    import argparse
    import json
    import pathlib

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("[portbench] no CUDA device", file=sys.stderr)
        return 2
    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path[0] = str(root)
    out = trace_cell(args.workload, args.seed)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
