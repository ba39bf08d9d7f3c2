"""CPU tests of the span reduction (``spans.py``): the innermost span
takes a kernel, a kernel is counted once however many host events the
profiler ties it to, device-side copies of spans are dropped (and with
a program that has no spans nothing else is), the port's Python and its
outermost ops are read under call spans; and a small CPU run of every
cell reads each value and logs the span table."""

import time
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import spans
from portbench.test_portbench_runs import SMALL

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


class Trace:
    """Profiler-like events: ``cpu(name, start, end, parent, kernels)``,
    ``dev(name, start, end)``."""

    def __init__(self):
        self.events = []
        self._ids = 0

    def cpu(self, name, start, end, parent=None, kernels=(), same_id=None):
        self._ids += 1
        e = SimpleNamespace(
            name=name, device_type=CPU, cpu_parent=parent,
            id=same_id.id if same_id is not None else self._ids,
            time_range=SimpleNamespace(start=start, end=end),
            kernels=[SimpleNamespace(name=k, duration=d)
                     for k, d in kernels])
        self.events.append(e)
        return e

    def dev(self, name, start, end):
        self.events.append(SimpleNamespace(
            name=name, device_type=CUDA, cpu_parent=None, id=0, kernels=[],
            time_range=SimpleNamespace(start=start, end=end)))


def _step_trace():
    t = Trace()
    call = t.cpu("portbench.call", 0, 1000)
    step = t.cpu("fold.step", 10, 900, call)
    commit = t.cpu("fold.commit", 100, 500, step)
    slot = t.cpu("model.slot_product", 120, 300, commit)
    mul = t.cpu("aten::mul", 130, 200, slot, [("k_mul", 50.0)])
    t.cpu("Activity Buffer Request", 131, 140, mul, [("k_mul", 50.0)],
          same_id=mul)
    t.cpu("cudaLaunchKernel", 150, 160, mul)
    t.cpu("aten::sum", 320, 380, commit, [("k_sum", 30.0)])
    crt = t.cpu("model.crt", 600, 700, step, [("fold_end", 8.0)])
    t.cpu("cudaLaunchKernel", 650, 660, crt)
    t.cpu("aten::add", 800, 850, step, [("k_add", 4.0)])
    t.cpu("aten::copy_", 950, 990, call, [("k_copy", 2.0)])
    for name, s, e in (("k_mul", 400, 450), ("k_sum", 460, 490),
                       ("fold_end", 700, 708), ("k_add", 860, 864),
                       ("k_copy", 995, 997)):
        t.dev(name, s, e)
    return t


def test_a_kernel_belongs_to_its_innermost_span():
    out = spans.reduce(_step_trace().events, calls=1)
    dev = {n: r["device_ms"] for n, r in out["spans"].items()}
    assert dev == pytest.approx({"fold.step": 0.004, "fold.commit": 0.030,
                                 "model.slot_product": 0.050,
                                 "model.crt": 0.008})
    assert out["readings"]["slot_product_ms"] == pytest.approx(0.050)
    assert "digit_prep_ms" not in out["readings"]
    # k_mul tied to two host events of one id counts once
    assert out["tied_ms"] == pytest.approx(0.094)
    assert out["unspanned_share"] == pytest.approx(2 / 94)
    self_ms = {n: r["host_self_ms"] for n, r in out["spans"].items()}
    assert self_ms["fold.step"] == pytest.approx((890 - 400 - 100) * 1e-3)
    assert self_ms["fold.commit"] == pytest.approx((400 - 180) * 1e-3)


def test_python_and_ops_under_call_spans():
    out = spans.reduce(_step_trace().events, calls=2)
    # fold.step 890 us, covered by aten::mul (70), aten::sum (60), the
    # hand kernel's launch (10), aten::add (50)
    assert out["readings"]["port_py_ms"] == pytest.approx(
        (890 - 190) * 1e-3 / 2)
    assert out["readings"]["ops_per_call"] == 3 / 2


def test_device_copies_of_spans_are_dropped():
    t = _step_trace()
    t.dev("fold.step", 400, 864)
    t.dev("model.slot_product", 400, 450)
    t.dev("portbench.call", 400, 997)
    t.events[0].kernels.append(SimpleNamespace(name="portbench.call",
                                               duration=597.0))
    out = spans.reduce(t.events, calls=1)
    assert out["copies_dropped"] == 2
    assert out["device_ms"] == pytest.approx(0.094)
    assert out["tied_ms"] == pytest.approx(0.094)


def test_a_program_without_spans_reads_nothing_and_drops_nothing():
    t = Trace()
    call = t.cpu("portbench.call", 0, 100)
    t.cpu("aten::mul", 10, 20, call, [("k_mul", 5.0)])
    t.dev("k_mul", 30, 35)
    t.dev("model.slot_product", 30, 35)     # a kernel, not a span's copy
    out = spans.reduce(t.events, calls=1)
    assert out["readings"] == {} and out["spans"] == {}
    assert out["copies_dropped"] == 0
    assert out["device_ms"] == pytest.approx(0.010)
    assert out["unspanned_share"] == 1.0


@pytest.mark.parametrize("name,want", [
    ("fold.step", True), ("fold.l2", True), ("model.slot_product", True),
    ("digits.planes", True),
    ("mxu.forward", True), ("portbench.call", False), ("aten::mul", False),
    ("cudaLaunchKernel", False), ("fold.step.x", False)])
def test_program_span_names(name, want):
    assert spans.is_program_span(name) == want


DIGITS = {"digits.planes", "digits.offsets"}
CELLS = {   # traffic -> cell, the spans of one call
    "fold-W16": ("gl24-L16384-fold-W16", DIGITS | {
        "fold.precompute", "fold.step", "fold.challenge", "fold.decompose",
        "fold.l2", "fold.commit", "fold.psi", "model.crt", "model.icrt",
        "model.slot_product"}),
    "mul-B80": ("gl-pow16-mul-B80", DIGITS | {
        "mxu.mul", "mxu.forward", "mxu.pointwise", "mxu.inverse"}),
    "mul_t-B262144": ("gl24-mul_t-B262144", DIGITS | {
        "model.mul_t", "model.crt", "model.icrt", "model.slot_product"}),
}


@pytest.mark.parametrize("traffic", sorted(CELLS))
def test_cpu_run_reads_every_value(traffic, capsys):
    cell, names = CELLS[traffic]
    out = spans.trace_cell(cell, 2**33 + 5, 2, 2, device="cpu",
                           overrides=SMALL[traffic])
    assert set(out["spans"]) == names
    want = {"digit_prep_ms", "port_py_ms", "ops_per_call"}
    if traffic != "mul-B80":
        want.add("slot_product_ms")
    assert set(out["readings"]) == want
    assert out["readings"]["ops_per_call"] > 0
    assert out["copies_dropped"] == 0
    assert out["host_ms_traced"]["mean"] > 0
    err = capsys.readouterr().err
    assert "spans: span" in err and "spans: port_py_ms" in err


def test_without_a_card_the_command_exits(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t0 = time.perf_counter()
    assert spans.main(["--workload", "gl24-L16384-fold-W16",
                       "--seed", "1"]) == 2
    assert time.perf_counter() - t0 < 5
