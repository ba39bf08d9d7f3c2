"""The port's tracing spans (``stark_rings_tpu_torch/utils/trace.py``) on
the CPU at small sizes.

With no profiler recording, ``trace_span`` is the shared no-op: it
enters no ``record_function`` or function-scope range, calls no NVTX and
reads no clock (each of those patched to raise).  Under
``torch.profiler.profile`` each span is a CPU event, and the spans nest
as the layers do: ``FoldingStep.step`` (``fold.step``) holds its stages
in order, with every ``aten::`` op under one of them; the challenge's
precompute, ``TModelMul.mul_t`` and the engines' ``mul`` hold their
CRTs, slot products, transforms and digit planes and offsets."""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import stark_rings_tpu_torch.utils.trace as T
from stark_rings_tpu_torch.ops import TModelMul
from stark_rings_tpu_torch.ops.fold import Mxu2FusedNTT, Mxu2KernelNTT
from stark_rings_tpu_torch.ops.mxu2 import Mxu2NTT
from stark_rings_tpu_torch.protocol import FoldingStep
from stark_rings_tpu_torch.rings import get_ring
from stark_rings_tpu_torch.utils import trace_span

SPAN_LAYERS = ("fold", "model", "mxu", "digits")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _raise(*args, **kwargs):
    raise AssertionError("called while no profiler records")


@pytest.mark.parametrize("target", [
    (torch.profiler, "record_function"),
    (torch.autograd.profiler, "record_function"),
    (T, "_RecordFunctionFast"),
    (torch._C._autograd, "_profiler_enabled"),
    (torch.cuda.nvtx, "range_push"),
    (torch.cuda.nvtx, "range_pop"),
    (time, "perf_counter"),
    (time, "monotonic"),
], ids=lambda t: f"{t[0].__name__}.{t[1]}")
def test_span_without_profiler_enters_nothing(monkeypatch, target):
    with monkeypatch.context() as m:
        m.setattr(*target, _raise)
        span = trace_span("fold.step")
        with span:
            with trace_span("fold.commit") as inner:
                assert inner is None
    assert span is T._NO_SPAN and trace_span("other") is span


def test_span_is_a_range_only_while_a_profiler_records():
    assert trace_span("a") is T._NO_SPAN
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace_span("a") is not T._NO_SPAN
    assert trace_span("a") is T._NO_SPAN


def _is_span(e):
    return e.name.split(".")[0] in SPAN_LAYERS and "::" not in e.name


def _parent_span(e):
    """The innermost program span above event ``e``, or None."""
    e = e.cpu_parent
    while e is not None and not _is_span(e):
        e = e.cpu_parent
    return e


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, list(prof.events())


def _children(events, parent):
    """The program spans whose innermost enclosing span is ``parent``, in
    order of start."""
    kids = [e for e in events if _is_span(e) and _parent_span(e) is parent]
    return [e.name for e in sorted(kids, key=lambda e: e.time_range.start)]


def _one(events, name):
    found = [e for e in events if e.name == name]
    assert len(found) == 1, (name, len(found))
    return found[0]


@pytest.fixture(scope="module")
def fold_trace():
    ring = get_ring("goldilocks", device="cpu")
    fs = FoldingStep(ring, n_rows=2, wit_len=3, psi_check=True)
    rng = np.random.default_rng(0)
    c = fs.init_tables(rng)
    s0, s1, c0, c1 = (fs.rand_witness(2, rng) for _ in range(4))

    def call():
        rt = fs.precompute_challenge(ring.rand_coeff((), rng))
        return fs.step(c, s0, s1, c0[:, :, :2], c1[:, :, :2], rt)
    return _traced(call)[1]


@pytest.mark.parametrize("parent,children", [
    ("fold.step", ["fold.challenge", "model.icrt", "fold.decompose",
                   "fold.l2", "model.crt", "fold.commit", "fold.psi"]),
    ("fold.challenge", ["model.slot_product", "model.slot_product"]),
    ("fold.commit", ["model.slot_product"]),
    ("fold.precompute", ["model.crt"]),
    ("fold.decompose", []),
    ("fold.l2", []),
    ("fold.psi", []),
])
def test_fold_step_spans_nest_by_stage(fold_trace, parent, children):
    assert _children(fold_trace, _one(fold_trace, parent)) == children


def test_fold_step_ops_each_lie_under_a_stage(fold_trace):
    step = _one(fold_trace, "fold.step")
    under = {}
    for e in fold_trace:
        if not e.name.startswith("aten::"):
            continue
        span = _parent_span(e)
        while span is not None and span is not step \
                and _parent_span(span) is not step:
            span = _parent_span(span)
        if span is not None:
            under.setdefault(e.name, set()).add(span.name)
    assert under and all("fold.step" not in s for s in under.values())
    assert under["aten::all"] == {"fold.psi"}       # the ok_psi reductions
    assert "fold.decompose" in under["aten::reshape"]


@pytest.mark.parametrize("name", ["goldilocks", "babybear", "frog",
                                  "stark_prime"])
def test_mul_t_spans(name):
    ring = get_ring(name, device="cpu")
    tm = TModelMul(ring)
    rng = np.random.default_rng(1)
    a, b = (tm.to_t(ring.rand_coeff((3,), rng)) for _ in range(2))
    out, events = _traced(lambda: tm.mul_t(a, b))
    assert torch.equal(tm.from_t(out), ring.coeff_mul(tm.from_t(a),
                                                      tm.from_t(b)))
    assert _children(events, _one(events, "model.mul_t")) == [
        "model.crt", "model.crt", "model.slot_product", "model.icrt"]


@pytest.mark.parametrize("engine", [Mxu2NTT, Mxu2KernelNTT])
def test_engine_mul_spans(engine):
    e = engine(1 << 10, device="cpu")
    gen = torch.Generator().manual_seed(2)
    a, b = (torch.randint(0, 1 << 62, (2, 1 << 10), generator=gen)
            for _ in range(2))
    out, events = _traced(lambda: e.mul(a, b))
    assert torch.equal(out, Mxu2NTT(1 << 10, device="cpu").mul(a, b))
    call = _one(events, "mxu.mul")
    assert _children(events, call) == [
        "mxu.forward", "mxu.forward", "mxu.pointwise", "mxu.inverse"]
    for k in (k for k in events if _is_span(k) and _parent_span(k) is call):
        want = [] if k.name == "mxu.pointwise" else [
            "digits.planes", "digits.offsets"] * 2
        assert _children(events, k) == want


def test_fused_engine_mul_has_its_call_span():
    e = Mxu2FusedNTT(1 << 10, device="cpu")
    gen = torch.Generator().manual_seed(3)
    a, b = (torch.randint(0, 1 << 62, (2, 1 << 10), generator=gen)
            for _ in range(2))
    out, events = _traced(lambda: e.mul(a, b))
    assert torch.equal(out, Mxu2NTT(1 << 10, device="cpu").mul(a, b))
    assert _children(events, _one(events, "mxu.mul")) == [
        "digits.planes", "digits.offsets"] * 6


def test_blocked_commit_spans(monkeypatch):
    """A blocked commit (babybear, E = 9, M = 12 in blocks of 5): each
    block's products under ``model.slot_product`` and its widened sum
    under ``model.commit_acc``, then the fold mod q under one more
    ``model.commit_acc``; the same words as the unblocked commit."""
    ring = get_ring("babybear", device="cpu")
    fs = FoldingStep(ring, n_rows=2, wit_len=3, psi_check=True)
    rng = np.random.default_rng(3)
    c = fs.init_tables(rng)
    s0, s1, c0, c1 = (fs.rand_witness(2, rng) for _ in range(4))
    rt = fs.precompute_challenge(ring.rand_coeff((), rng))
    whole = fs.step(c, s0, s1, c0[:, :, :2], c1[:, :, :2], rt)
    monkeypatch.setattr(FoldingStep, "_COMMIT_BUDGET_WORDS",
                        ring.D * ring.E * 2 * 2 * 5)
    assert (fs.M, fs.commit_block(2)) == (12, 5)
    out, events = _traced(lambda: fs.step(c, s0, s1, c0[:, :, :2],
                                          c1[:, :, :2], rt))
    assert torch.equal(out["cd"], whole["cd"])
    assert _children(events, _one(events, "fold.commit")) == [
        "model.slot_product", "model.commit_acc"] * 3 + ["model.commit_acc"]


def test_stark_step_spans(monkeypatch):
    """stark_prime's E = 1 step (M = 12 in blocks of 5): the challenge's
    two field products under ``model.slot_product``; each commit block's
    products under ``model.slot_product`` and its widened sum under
    ``model.commit_acc``, then the fold mod q under one more
    ``model.commit_acc``; the same words as the unblocked commit."""
    ring = get_ring("stark_prime", device="cpu")
    fs = FoldingStep(ring, n_rows=2, wit_len=3, base=1 << 16,
                     psi_check=True)
    rng = np.random.default_rng(4)
    c = fs.init_tables(rng)
    s0, s1, c0, c1 = (fs.rand_witness(2, rng) for _ in range(4))
    rt = fs.precompute_challenge(ring.rand_coeff((), rng))
    args = (c, s0, s1, c0[:, :, :2], c1[:, :, :2], rt)
    whole, events = _traced(lambda: fs.step(*args))
    assert _children(events, _one(events, "fold.challenge")) == [
        "model.slot_product", "model.slot_product"]
    assert _children(events, _one(events, "fold.commit")) == [
        "model.slot_product"]
    monkeypatch.setattr(FoldingStep, "_COMMIT_BUDGET_WORDS",
                        ring.D * 2 * 2 * 8 * 20)
    assert (fs.M, fs.commit_block(2)) == (48, 20)
    out, events = _traced(lambda: fs.step(*args))
    assert torch.equal(out["cd"], whole["cd"])
    assert _children(events, _one(events, "fold.commit")) == [
        "model.slot_product", "model.commit_acc"] * 3 + ["model.commit_acc"]
