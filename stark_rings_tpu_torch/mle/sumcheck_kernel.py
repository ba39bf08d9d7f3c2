"""One-pass k-ary product sumcheck prover, kernel K7 (counterpart of
``stark_rings_tpu/mle/pallas_sumcheck.py``), over Goldilocks, BabyBear
and frog, for one claim or a batch of claims.

``sumcheck_prove_many(tables, challenges, field)`` proves S = sum_x
prod_j T_j(x) in msb order (challenge i binds variable nv-1-i) for
challenges given up front, and returns ``(msgs [nv, k+1], finals)``
exactly as ``sumcheck_prove_many_with_challenges(f, tables, challenges,
order="msb")`` does: per round p(0..k), and the k fully bound values.
That generic prover is the twin, ``sumcheck_prove_many_ref``.

``sumcheck_prove_batch_goldilocks(tables, challenges)`` proves W
Goldilocks claims that share one challenge vector, as the reference's
``sumcheck_prove_batch_goldilocks_pallas``: ``tables`` are k [W, 2^nv]
tensors, and it returns ``(msgs [W, nv, k+1], finals: k tensors [W])``.
Its twin, ``sumcheck_prove_batch_ref``, runs the generic prover once,
with the claims on a trailing axis of the tables; claim by claim that
is the generic prover's proof.

Tables and challenges are the field's storage, as in the reference:
int64 for Goldilocks (canonical) and frog (Montgomery, R = 2^64), int32
for BabyBear (Montgomery, R = 2^32).  The kernel's add, sub and mul are
the field's own on that storage, so nothing is converted.

On CUDA tensors the wrappers launch one ``csrc/mle.cu`` round kernel per
round (messages as per-block partials, and the fold with that round's
challenge into half-size tables in device memory) and one kernel that
reduces every round's partials to the messages: nv + 1 launches, no
host synchronisation, for every nv >= 1 and any number k of tables.  Up
to 8 tables the round kernel is instantiated for k and keeps its k + 1
sums and 3k words a thread in registers; beyond 8 a second round kernel
reads k at run time (the table pointers in device arrays) and makes one
pass over the entries for each 8 of the k + 1 sums.  The claims are the
kernels' second grid axis, at most 65,535 a launch; a larger batch runs
in chunks of that many claims, nv + 1 launches each.  The reference
hands small tables to the generic prover (nv < 12, and the last 10
rounds: its kernel works on rows of 128 lanes) and batches by calling
its kernel once per claim; here every round of every claim stays in the
round kernels.  Each field has its own C entry points,
``srt_sumcheck_round_<field>``, ``srt_sumcheck_round_wide_<field>`` and
``srt_sumcheck_reduce_<field>``.  Every launch adds one to
``LAUNCHES["sumcheck_prove_many_<field>"]`` or
``LAUNCHES["sumcheck_prove_batch_goldilocks"]``.  With nv = 0 there is
no round: the proof is the empty message tensor and the tables' one
entries, and nothing is launched.  CPU tensors get the twins.
"""

from __future__ import annotations

import ctypes

import torch

from ..fields.field import FIELDS
from ..ops import _build
from .fix import as_points
from .sumcheck import sumcheck_prove_many_with_challenges

__all__ = ["sumcheck_prove_many", "sumcheck_prove_many_goldilocks",
           "sumcheck_prove_goldilocks", "sumcheck_prove_batch_goldilocks",
           "sumcheck_prove_many_ref", "sumcheck_prove_batch_ref",
           "SUMCHECK_FIELDS", "LAUNCHES", "reset_launches"]

#: the fields K7 runs over
SUMCHECK_FIELDS = ("goldilocks", "babybear", "frog")

_BATCH = "sumcheck_prove_batch_goldilocks"
LAUNCHES = {**{f"sumcheck_prove_many_{field}": 0
               for field in SUMCHECK_FIELDS}, _BATCH: 0}

_MAX_K = 8              # tables of the register kernel; more go wide
_MAX_CLAIMS = 65535     # claims per launch (the grid's second axis)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _field(field: str):
    if field not in SUMCHECK_FIELDS:
        raise ValueError(f"no sumcheck kernel for field {field!r}: K7 runs "
                         f"over {sorted(SUMCHECK_FIELDS)} (the 8-limb "
                         "stark_prime waits for ROADMAP Slice C item 9)")
    return FIELDS[field]


def sumcheck_prove_many_ref(tables, challenges, field: str = "goldilocks"):
    """Plain twin of :func:`sumcheck_prove_many`: the generic msb
    prover."""
    return sumcheck_prove_many_with_challenges(FIELDS[field], tables,
                                               challenges, order="msb")


def sumcheck_prove_batch_ref(tables, challenges):
    """Plain twin of :func:`sumcheck_prove_batch_goldilocks`: the generic
    msb prover on the [2^nv, W] transposed tables, every claim at once
    (each round's sums and folds run along the table axis)."""
    msgs, finals = sumcheck_prove_many_ref([T.t() for T in tables],
                                           challenges)
    return msgs.permute(2, 0, 1).contiguous(), finals


def _prepare(name, f, tables, challenges, lead):
    """Check k tables of ``f``'s storage, each of shape ``lead + (2^nv,)``
    for nv = len(challenges); returns the challenges as a storage tensor
    on the tables' device and whether that device is the card."""
    nv = len(challenges)
    if not tables:
        raise ValueError(f"{name}: no tables")
    want = (*lead, 1 << nv)
    for T in tables:
        if not isinstance(T, torch.Tensor) or T.dtype != f.dtype \
                or tuple(T.shape) != want:
            raise ValueError(f"{name}: every table must be {f.dtype} "
                             f"{list(want)} for {nv} challenges")
    chal = as_points(challenges, tables[0].device, f.dtype)
    card = _build.on_cuda(name, *tables, chal)
    if card and not all(T.is_contiguous() for T in tables):
        raise ValueError(f"{name}: tables must be contiguous")
    return chal, card


def _prove_on_card(name, f, tables, chal, W):
    """K7 for W claims over field ``f``, counted in ``LAUNCHES[name]``:
    tables are k contiguous tensors of W rows of 2^nv words, nv >= 1.
    nv + 1 launches for each chunk of up to ``_MAX_CLAIMS`` claims.
    Returns (msgs [W, nv, k+1], finals [W, k])."""
    if W > _MAX_CLAIMS:
        parts = [_prove_on_card(name, f, [T[w:w + _MAX_CLAIMS]
                                          for T in tables], chal,
                                min(_MAX_CLAIMS, W - w))
                 for w in range(0, W, _MAX_CLAIMS)]
        return tuple(torch.cat(x) for x in zip(*parts))
    k, nv = len(tables), chal.shape[0]
    half = 1 << (nv - 1)
    dev = tables[0].device
    lib = _build.kernels()
    rows = lib.srt_sumcheck_partial_rows(half, nv, W)
    scratch = torch.empty((W, k, half), dtype=f.dtype, device=dev)
    partials = torch.empty((rows, k + 1), dtype=f.dtype, device=dev)
    msgs = torch.empty((W, nv, k + 1), dtype=f.dtype, device=dev)
    ptrs = ([T.data_ptr() for T in tables],
            [s.data_ptr() for s in scratch[0]])
    if k <= _MAX_K:                 # host arrays, copied into the launch
        ins, outs = ((ctypes.c_void_p * k)(*x) for x in ptrs)
        round_fn = getattr(lib, f"srt_sumcheck_round_{f.name}")
    else:                           # device arrays, read by the kernel
        ptrs = [torch.tensor(x, dtype=torch.int64).pin_memory().to(
            dev, non_blocking=True) for x in ptrs]
        ins, outs = (x.data_ptr() for x in ptrs)
        round_fn = getattr(lib, f"srt_sumcheck_round_wide_{f.name}")
    in_claim, out_claim = 2 * half, k * half   # words from claim to claim
    reduce_fn = getattr(lib, f"srt_sumcheck_reduce_{f.name}")
    for i in range(nv):
        _build.launch(LAUNCHES, name, round_fn, dev, ins, outs, k, W,
                      in_claim, out_claim, half >> i, chal.data_ptr(), i, nv,
                      partials.data_ptr())
        ins, in_claim = outs, out_claim    # later rounds fold in place
    _build.launch(LAUNCHES, name, reduce_fn, dev, partials.data_ptr(),
                  msgs.data_ptr(), k + 1, nv, W, half)
    return msgs, scratch[:, :, 0]


def _no_rounds(f, tables, *lead):
    """The messages of a proof with no variable: [*lead, 0, k+1]."""
    return torch.empty((*lead, 0, len(tables) + 1), dtype=f.dtype,
                       device=tables[0].device)


def sumcheck_prove_many(tables, challenges, field: str = "goldilocks"):
    """k-ary product sumcheck prover, msb order: ``tables`` k [2^nv]
    storage tensors of ``field``, ``challenges`` nv field elements (a
    1-D storage tensor, or scalars).  Returns (msgs [nv, k+1], finals: k
    0-d tensors)."""
    f = _field(field)
    name = f"sumcheck_prove_many_{field}"
    chal, card = _prepare(name, f, tables, challenges, ())
    if not card:
        return sumcheck_prove_many_ref(tables, chal, field)
    if chal.shape[0] == 0:                   # no round: nothing to launch
        return _no_rounds(f, tables), [T[0] for T in tables]
    msgs, finals = _prove_on_card(name, f, tables, chal, 1)
    return msgs[0], list(finals[0])


def sumcheck_prove_many_goldilocks(tables, challenges):
    return sumcheck_prove_many(tables, challenges, field="goldilocks")


def sumcheck_prove_goldilocks(G, H, challenges):
    """Product-of-two prover (msb order): (msgs [nv, 3], g_final,
    h_final)."""
    msgs, finals = sumcheck_prove_many_goldilocks([G, H], challenges)
    return msgs, finals[0], finals[1]


def sumcheck_prove_batch_goldilocks(tables, challenges):
    """W Goldilocks claims sharing one challenge vector, as the
    reference's ``sumcheck_prove_batch_goldilocks_pallas``: ``tables`` k
    int64 [W, 2^nv] tensors.  Returns (msgs [W, nv, k+1], finals: k
    tensors [W]); claim w's proof is that of ``sumcheck_prove_many`` on
    the tables' row w."""
    W = tables[0].shape[0] if tables and tables[0].dim() == 2 else 0
    if W < 1:
        raise ValueError(f"{_BATCH}: tables must be [W, 2^nv] with W >= 1")
    f = FIELDS["goldilocks"]
    chal, card = _prepare(_BATCH, f, tables, challenges, (W,))
    if not card:
        return sumcheck_prove_batch_ref(tables, chal)
    if chal.shape[0] == 0:
        return _no_rounds(f, tables, W), [T[:, 0] for T in tables]
    msgs, finals = _prove_on_card(_BATCH, f, tables, chal, W)
    return msgs, list(finals.unbind(1))
