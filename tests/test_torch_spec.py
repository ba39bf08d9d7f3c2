"""The port's copy of the integer spec (``stark_rings_tpu_torch/spec``)
against the reference's ``stark_rings_tpu/spec``: every field of every
model, every CRT/ICRT stage on basis and random vectors, the ring-level
functions, the decomposition helpers, and the Rust golden vectors of
``tests/test_spec_golden.py`` run on the port's models.  Pure Python:
the tolerance is equality of integers."""

import importlib.util
import inspect
import pathlib
import random

import pytest

from stark_rings_tpu import spec as ref_spec
from stark_rings_tpu.spec import decomp as ref_decomp
from stark_rings_tpu.spec import field as ref_field

from stark_rings_tpu_torch import spec
from stark_rings_tpu_torch.spec import decomp, field

NAMES = ["goldilocks", "babybear", "frog", "stark_prime"]
FIELDS = ["name", "q", "D", "N", "E", "nr", "root", "root_order", "roots",
          "slot_powers", "storage_perm", "n_raw_stages", "has_middle_term"]


def _golden_module():
    """tests/test_spec_golden.py, loaded under another name with its
    models rebound to the port's."""
    path = pathlib.Path(__file__).with_name("test_spec_golden.py")
    ld = importlib.util.spec_from_file_location("_golden_on_port", path)
    mod = importlib.util.module_from_spec(ld)
    ld.loader.exec_module(mod)
    mod.MODELS, mod.get_model, mod.modinv = (spec.MODELS, spec.get_model,
                                             spec.modinv)
    mod.GL, mod.BB, mod.FR, mod.SP = (spec.get_model(n) for n in NAMES)
    return mod


GOLDEN = _golden_module()
GOLDEN_TESTS = sorted(n for n, f in vars(GOLDEN).items()
                      if n.startswith("test_") and inspect.isfunction(f))


def test_copy_has_the_reference_models():
    assert list(spec.MODELS) == list(ref_spec.MODELS) == NAMES
    assert spec.get_model("frog") is spec.MODELS["frog"]
    assert spec.modpow(3, 5, 7) == ref_spec.modpow(3, 5, 7)
    assert spec.modinv(3, 7) == ref_spec.modinv(3, 7)


@pytest.mark.parametrize("name", NAMES)
def test_model_tables_match_reference(name):
    m, r = spec.get_model(name), ref_spec.get_model(name)
    for key in FIELDS:
        assert getattr(m, key) == getattr(r, key), key
    assert len(m.crt_stages) == len(r.crt_stages)
    assert len(m.icrt_stages) == len(r.icrt_stages)
    rng = random.Random(name)
    vecs = [[int(i == j) for i in range(m.D)] for j in range(m.D)]
    vecs += [[rng.randrange(m.q) for _ in range(m.D)] for _ in range(3)]
    for stages, ref_stages in ((m.crt_stages, r.crt_stages),
                               (m.icrt_stages, r.icrt_stages)):
        for st, rst in zip(stages, ref_stages):
            for v in vecs:
                x, y = list(v), list(v)
                st(x)
                rst(y)
                assert x == y
    a, b = vecs[-2], vecs[-1]
    long = vecs[-3] + vecs[-2][:m.D - 1]
    for fn in ("crt", "icrt", "crt_raw", "rot"):
        assert getattr(m, fn)(a) == getattr(r, fn)(a), fn
    for fn in ("ntt_mul", "coeff_mul", "ext_mul"):
        assert getattr(m, fn)(a, b) == getattr(r, fn)(a, b), fn
    assert m.reduce(long) == r.reduce(long)
    assert m.ext_from_scalar(7) == r.ext_from_scalar(7)


@pytest.mark.parametrize("q", [ref_spec.get_model(n).q for n in NAMES[:3]])
def test_field_and_decomp_helpers_match_reference(q):
    rng = random.Random(q)
    xs = [0, 1, q - 1, (q - 1) // 2, (q + 1) // 2] + [rng.randrange(q)
                                                      for _ in range(20)]
    for x in xs:
        for fn in ("to_signed", "from_signed", "center", "sign"):
            assert getattr(field, fn)(x, q) == getattr(ref_field, fn)(x, q)
        if x:
            assert field.modinv(x, q) == ref_field.modinv(x, q)
    for b in (2, 4, 16, 256):
        k = decomp.decomposition_max_length(q, b)
        assert k == ref_decomp.decomposition_max_length(q, b)
        for x in xs:
            v = decomp.to_signed(x, q)
            assert v == ref_decomp.to_signed(x, q)
            digits = decomp.decompose_balanced(v, b, k)
            assert digits == ref_decomp.decompose_balanced(v, b, k)
            assert digits == decomp.decompose_balanced_ref(v, b, k)
            assert decomp.decompose_balanced(v, b) == \
                ref_decomp.decompose_balanced(v, b)
            assert decomp.recompose_ints(digits, b) == v
        assert decomp.decompose_to_vec([decomp.to_signed(x, q) for x in xs],
                                       b) == ref_decomp.decompose_to_vec(
            [ref_decomp.to_signed(x, q) for x in xs], b)
    for a, d in ((7, 2), (-7, 2), (7, -3), (-9, 4)):
        assert decomp.trunc_div(a, d) == ref_decomp.trunc_div(a, d)
        assert decomp.trunc_rem(a, d) == ref_decomp.trunc_rem(a, d)
        assert decomp.rounded_div(a, d) == ref_decomp.rounded_div(a, d)


@pytest.mark.parametrize("test", GOLDEN_TESTS)
def test_golden_vectors_on_the_copy(test):
    """Each golden-vector test of tests/test_spec_golden.py, run on the
    port's models."""
    assert GOLDEN.GL is spec.get_model("goldilocks")
    getattr(GOLDEN, test)()
