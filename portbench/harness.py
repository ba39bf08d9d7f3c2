"""The benchmark's generic runner: one cell, one seed, one run.

Everything that belongs to one cell is found by name:

* the cell: an entry of ``workloads`` in ``BENCHMARK.json``;
* its configuration: the file that ``configs`` names for it;
* its traffic mix: ``traffic/<traffic>.json``, data that names the entry
  point it drives (``entries/<entry>.py``) and its sizes;
* each metric: ``metrics/<name>.py``, else ``metrics/<stem>.py`` for the
  part of the name before the first dot;
* each kernel's operations and bytes: ``roofline/<kernel>.py``.

A run builds the entry's inputs from the seed on the device, warms up
with the cell's own calls, then drives a closed loop for the window:
each call starts when the previous one has finished and takes the
previous call's outputs as its inputs.  After the window (and, with
``trace``, a profiled stretch of the same loop) the program's objects
are released and a seeded sample of the calls is recomputed by the
plain reference under ``reference/`` and compared word for word.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import pathlib
import random
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field

import torch

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
PROGRAM = "stark_rings_tpu_torch"
#: top-level modules that may not be loaded in a run's process
BANNED = ("jax", "jaxlib", "flax", "stark_rings_tpu")


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# finding things by name
# ---------------------------------------------------------------------------

def load_json(path: pathlib.Path):
    with open(path) as fh:
        return json.load(fh)


def manifest(root: pathlib.Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def by_name(items, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_module(path: pathlib.Path):
    """Import one file of the benchmark by path (names may hold dots)."""
    name = "portbench_" + "_".join(path.with_suffix("").parts[-2:]).replace(
        ".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def metric_module(name: str, bench: pathlib.Path = BENCH):
    for stem in (name, name.split(".")[0]):
        path = bench / "metrics" / f"{stem}.py"
        if path.is_file():
            return load_module(path)
    raise FileNotFoundError(f"no reader metrics/{name}.py or "
                            f"metrics/{name.split('.')[0]}.py")


def roofline_module(kernel: str, bench: pathlib.Path = BENCH):
    path = bench / "roofline" / f"{kernel}.py"
    return load_module(path) if path.is_file() else None


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def cell(name: str, overrides: dict | None = None,
         root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration and traffic loaded;
    ``overrides`` ({"config": {...}, "traffic": {...}}) replaces keys,
    for the CPU tests' small sizes."""
    man = manifest(root)
    wl = by_name(man["workloads"], name, "workload")
    cfg_entry = by_name(man["configs"], wl["config"], "config")
    config = load_json(root / cfg_entry["file"])
    traffic = load_json(root / BENCH.name / "traffic"
                        / f"{wl['traffic']}.json")
    overrides = overrides or {}
    config.update(overrides.get("config", {}))
    traffic.update(overrides.get("traffic", {}))
    e2e = [m for m in man["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return Cell(name, wl["chips"], config, traffic, e2e, per_layer)


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

@dataclass
class RunState:
    """What a run measured, handed to the metric readers."""
    cell: Cell
    setup_s: float = 0.0
    window_s: float = 0.0
    calls: int = 0
    units: int = 0                      # W or B a call
    call_ms: list = field(default_factory=list)     # device timestamps
    host_ms: list = field(default_factory=list)     # call start -> return
    trace: object = None                # trace.TraceSummary
    peaks: dict | None = None


def uniform_words(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Goldilocks storage words drawn from ``gen``: hi < 2^32 - 1, so
    every word is below 2^64 - 2^32 < q."""
    hi = torch.randint(0, (1 << 32) - 1, shape, generator=gen,
                       dtype=torch.int64, device=device)
    lo = torch.randint(0, 1 << 32, shape, generator=gen, dtype=torch.int64,
                       device=device)
    return (hi << 32) | lo


class ChainedProduct:
    """An entry whose call is one product ``c = mul(a, b)`` of seeded
    storage words: a call's ``a`` is the previous call's product, ``b``
    cycles through a pool made on the device in set-up.  A subclass sets
    ``units`` (products a call), ``self.a``, ``self.pool``, ``self._mul``
    and :meth:`expected`, the reference's product."""

    def next_inputs(self, index):
        return {"a": self.a, "b": index % self.pool.shape[0]}

    def call(self, inputs):
        return {"c": self._mul(inputs["a"], self.pool[inputs["b"]])}

    def finish(self, outputs):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def advance(self, outputs):
        self.a = outputs["c"]

    def release(self):
        self._mul = self.a = None

    def check(self, inputs, outputs):
        return mismatches(outputs, {"c": self.expected(
            inputs["a"], self.pool[inputs["b"]])})


def _no_span(name):
    return contextlib.nullcontext()


def mismatches(outputs: dict, expected: dict) -> tuple[int, int]:
    """(differing words, compared words) of the outputs against the
    reference's; a missing or misshapen output counts whole."""
    bad = total = 0
    for key, want in expected.items():
        got = outputs.get(key)
        total += want.numel()
        if not isinstance(got, torch.Tensor) or got.shape != want.shape:
            bad += want.numel()
            continue
        bad += int((got.to(want.device) != want).sum())
    return bad, total


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Clock:
    """Times one call by the device's own timestamps: an event recorded
    as the call starts (the stream has drained: the loop is closed) and
    one after its last operation, recorded when the call returns and
    before the host waits.  The span holds the call's device work and
    the gaps in which the device waited for the host to launch it.  On
    the CPU the host clock stands in."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e1 = torch.cuda.Event(enable_timing=True)

    def start(self):
        self.t0 = time.perf_counter()
        if self.cuda:
            self.e0.record()

    def mark(self):
        self.t1 = time.perf_counter()
        if self.cuda:
            self.e1.record()

    def elapsed_ms(self) -> float:
        if self.cuda:
            self.e1.synchronize()
            return self.e0.elapsed_time(self.e1)
        return (self.t1 - self.t0) * 1e3


def host_probe() -> str:
    """The host's speed at the run's start: the milliseconds of a fixed
    piece of Python, and the cores the process may run on."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(300_000):
        acc += i & 7
    ms = (time.perf_counter() - t0) * 1e3
    try:
        cores = sorted(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        cores = []
    return f"host probe {ms:.3f} ms; cores {cores}"


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0].split(",")[-1].strip() if out else None


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", overrides: dict | None = None,
        program: str = "program", root: pathlib.Path = ROOT) -> dict:
    """One run of one cell; returns the result line's object.

    ``program``: ``"program"`` drives the port; ``"control"`` drives the
    reference at half-width products in its place (the comparison has
    to reject it)."""
    log(host_probe())
    c = cell(cell_name, overrides, root)
    dev = torch.device(device)
    entry_mod = load_module(BENCH / "entries" / f"{c.traffic['entry']}.py")
    entry = entry_mod.Entry(c.config, c.traffic, seed, dev, program)
    st = RunState(c, units=entry.units)
    rng = random.Random(seed)
    k_sample = int(c.traffic["check_calls"])
    sample: list = []
    clock = _Clock(dev)

    def one_call(index, span=_no_span):
        with span("portbench.inputs"):
            inputs = entry.next_inputs(index)
        clock.start()
        t0 = time.perf_counter()
        with span("portbench.call"):
            outputs = entry.call(inputs)
        t_ret = time.perf_counter()
        clock.mark()
        with span("portbench.finish"):
            entry.finish(outputs)
            ms = clock.elapsed_ms()
        entry.advance(outputs)
        return inputs, outputs, ms, (t_ret - t0) * 1e3

    # set-up: the entry's objects and inputs are built; warm up
    first = None
    for i in range(int(c.traffic["warmup_calls"])):
        inputs, outputs, _, _ = one_call(i)
        if first is None:
            first = (i, inputs, outputs)     # the start: the seed's inputs
    _sync(dev)
    index = int(c.traffic["warmup_calls"])
    st.setup_s = time.perf_counter() - t_start

    def keep(rec, seen):
        """Reservoir sample of k_sample calls, uniform over those seen."""
        if len(sample) < k_sample:
            sample.append(rec)
        else:
            j = rng.randrange(seen)
            if j < k_sample:
                sample[j] = rec

    seen = 0
    t_w0 = time.perf_counter()
    while True:
        inputs, outputs, ms, host = one_call(index)
        st.call_ms.append(ms)
        st.host_ms.append(host)
        seen += 1
        keep((index, inputs, outputs), seen)
        index += 1
        if time.perf_counter() - t_w0 >= seconds:
            break
    st.window_s = time.perf_counter() - t_w0
    st.calls = len(st.call_ms)
    attempted = st.calls

    if trace:
        from torch.profiler import record_function

        from . import trace as tr
        calls_traced = int(c.traffic["trace_calls"])

        def traced_call(i):
            nonlocal seen
            inputs, outputs, _, _ = one_call(i, record_function)
            seen += 1
            keep((i, inputs, outputs), seen)

        st.trace = tr.profile(traced_call, index, calls_traced, dev)
        attempted += calls_traced
        st.peaks = tr.peaks_for(torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else "cpu")

    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)

    # the comparison, once the program's objects are gone
    entry.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checked = [first] + sorted(sample, key=lambda r: r[0])
    mismatched = compared = failed = 0
    for i, inputs, outputs in checked:
        bad, n = entry.check(inputs, outputs)
        mismatched += bad
        compared += n
        failed += bad > 0
    _sync(dev)
    log(f"reference checked calls {[r[0] for r in checked]}, "
        f"{compared} words, in {time.perf_counter() - t_ref:.3f} s")
    # every output word of the checked calls, bit for bit: limit 0
    check = {"mismatched_words": {"value": mismatched, "limit": 0}}
    correct = mismatched == 0

    metrics = {}
    wanted = c.per_layer if trace else c.end_to_end
    for m in wanted:
        value = metric_module(m["name"]).read(st)
        if value is None:
            log(f"metric {m['name']}: nothing to read in this run")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    log(f"{st.calls} calls in {st.window_s:.6f} s; call ms median "
        f"{statistics.median(st.call_ms):.6f}, max {max(st.call_ms):.6f};"
        f" host ms a call median {statistics.median(st.host_ms):.6f}")

    out = {
        "correct": bool(correct),
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": 1,
            "memory_peak_bytes": memory_peak,
            "power_limit": power_limit() if dev.type == "cuda" else None,
        },
    }
    if trace:
        out["device"]["busy_s"] = st.trace.busy_s
        out["device"]["window_s"] = st.trace.window_s
        out["breakdown"] = st.trace.breakdown()
    out["check"] = check
    for name, v in check.items():
        log(f"check {name} {v['value']} limit {v['limit']}")
    return out


def banned_modules(names=None) -> list[str]:
    """The banned top-level names among the loaded modules' (or
    ``names``), each compared whole: ``stark_rings_tpu_torch`` is not
    ``stark_rings_tpu``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names
                   if m.split(".")[0] in BANNED})
