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

On CUDA tensors the wrappers prove with ``csrc/mle.cu``, one
cooperative launch a proof, as the reference's proof is one
``pallas_call``.  Up to 8 tables ``sumcheck_prove_kernel`` runs the
rounds in a loop inside the kernel: the rounds on big tables in grid
phases of up to 4 rounds (a thread holds its 2^m entries of each table
in registers and folds them m times; per-block partial sums; the folded
tables in device memory) separated by grid-wide barriers, then one block
per claim finishes the small rounds in shared memory and reduces the
partials to the messages.  Beyond 8 tables ``sumcheck_wide_kernel``
reads k at run time and runs the same schedule, one round a grid phase:
each entry's k + 1 sums are split over threads 8 at a time, so a
round's chain of dependent products is k long; a grid round first
copies its block's entries into shared memory with every load in
flight; after the last grid round every block of the grid sums partial
rows into messages; and the table pointers ride in the launch
parameters (up to 64 tables; beyond, a device array uploaded for the
call).  A proof of nv + 1 launches (one a round, one reduction: the
first design, at every k) was bound by the host's launches; one launch
leaves round 0's read of the tables, the barriers, the one-block tail
and this wrapper's host time, and beyond 8 tables the k - 1 products a
message sum.
:func:`plan` is the launch plan: the chunks of claims, the grid phases
and their blocks, and the round where the one-block tail begins.  The
claims of a batch are virtual blocks of the launch, at most 65,535 a
launch; a larger batch runs in chunks of that many claims.  The
reference hands small tables to the generic prover (nv < 12, and the
last 10 rounds: its kernel works on rows of 128 lanes) and batches by
calling its kernel once per claim; here every round of every claim
stays in the kernel.  Each field has its own C entry point,
``srt_sumcheck_prove_<field>``.  Every launch adds one to
``LAUNCHES["sumcheck_prove_many_<field>"]`` or
``LAUNCHES["sumcheck_prove_batch_goldilocks"]``; ``LAST_GRID`` keeps the
grid and resident blocks an SM of the last launch.  With nv = 0 there is
no round: the proof is the empty message tensor and the tables' one
entries, and nothing is launched.  A device that cannot launch
cooperatively raises; there is no per-round fallback.  CPU tensors get
the twins.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..fields.field import FIELDS, STARK
from ..ops import _build
from .fix import as_points
from .sumcheck import sumcheck_prove_many_with_challenges

__all__ = ["sumcheck_prove_many", "sumcheck_prove_many_goldilocks",
           "sumcheck_prove_goldilocks", "sumcheck_prove_batch_goldilocks",
           "sumcheck_prove_many_ref", "sumcheck_prove_batch_ref",
           "SUMCHECK_FIELDS", "LAUNCHES", "LAST_GRID", "reset_launches",
           "plan", "Plan", "wide_groups"]

#: the fields K7 runs over
SUMCHECK_FIELDS = ("goldilocks", "babybear", "frog")

_BATCH = "sumcheck_prove_batch_goldilocks"
LAUNCHES = {**{f"sumcheck_prove_many_{field}": 0
               for field in SUMCHECK_FIELDS}, _BATCH: 0}

#: (grid, resident blocks an SM) of the last launch, by name
LAST_GRID = {}

# the constants of csrc/mle.cu that the plan follows
_MAX_K = 8              # tables of the persistent kernel; more go wide
_MAX_CLAIMS = 65535     # SC_MAX_CLAIMS: claims per launch
_THREADS = 256          # SC_THREADS
_MAX_BLOCKS = 1024      # SC_MAX_BLOCKS: the most blocks a round takes
_TAIL_BYTES = 32 * 1024  # SC_TAIL_BYTES: a tail block's tables
_TAIL_HALF = 1024       # SC_TAIL_HALF: the largest half a tail round takes
_PHASE_BYTES = 128      # SC_PHASE_BYTES: a thread's entries in a phase
_MAX_PHASE = 4          # SC_MAX_PHASE: the most rounds a phase takes
_WIDE_T = 8             # SC_WIDE_T: message sums a thread takes (k > 8)
_WIDE_GROUPS = 32       # SC_WIDE_GROUPS: most threads an entry
_WIDE_PTRS = 64         # SC_WIDE_PTRS: table pointers in the parameters


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _field(field: str):
    if field not in SUMCHECK_FIELDS:
        raise ValueError(f"no sumcheck kernel for field {field!r}: K7 runs "
                         f"over {sorted(SUMCHECK_FIELDS)}")
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


class Plan(NamedTuple):
    """How K7 proves W claims of k tables with nv variables.

    ``chunks``: (first claim, claims) of each chunk, one launch each.
    ``tail``: the first round of the one-block tail (nv when no round
    fits it).  ``phases``: (first round, rounds) of each grid phase
    before the tail, each ended by a grid barrier (one round a phase
    beyond 8 tables).  ``blocks``: the blocks a claim takes in each
    round before the tail, each writing one partial row: a phase's
    rounds take the blocks of its last round.  ``rows``: partial rows a
    claim, their sum.  ``launches``: per chunk, 1."""

    chunks: tuple
    tail: int
    phases: tuple
    blocks: tuple
    rows: int
    launches: int


def _blocks(half: int) -> int:
    return min(_MAX_BLOCKS, -(-half // _THREADS))


def wide_groups(k: int) -> int:
    """Threads an entry beyond 8 tables: the groups of 8 of the k + 1
    message sums, rounded up to a power of 2, at most 32 (more groups
    take further passes)."""
    g, p = (k + _WIDE_T) // _WIDE_T, 1
    while p < g and p < _WIDE_GROUPS:
        p *= 2
    return p


def _wide_blocks(half: int, k: int) -> int:
    return min(_MAX_BLOCKS, -(-half // (_THREADS // wide_groups(k))))


@functools.lru_cache(maxsize=256)
def plan(nv: int, k: int, word_bytes: int, W: int = 1) -> Plan:
    """The launch plan of a proof of W claims, k tables of ``word_bytes``
    words and nv >= 1 variables, by the rules ``csrc/mle.cu`` checks.
    Round i has half = 2^(nv-1-i).  The tail begins at the first round
    whose k tables of 2*half words fit 32 KB, with half <= 1024.  A grid
    phase takes the most rounds m <= 4 whose 2^m entries of each table
    fit 128 bytes a thread (at least one; one beyond 8 tables), and the
    last phase ends at the tail.  Up to 8 tables a round's blocks take
    256 entries each; beyond, 256 / ``wide_groups(k)``."""
    if nv < 1 or k < 1 or W < 1:
        raise ValueError(f"plan: need nv, k, W >= 1, got {nv}, {k}, {W}")
    half0 = 1 << (nv - 1)
    chunks = tuple((w, min(_MAX_CLAIMS, W - w))
                   for w in range(0, W, _MAX_CLAIMS))
    h = _TAIL_HALF
    while 2 * h * k * word_bytes > _TAIL_BYTES:
        h //= 2
    tail = next((i for i in range(nv) if half0 >> i <= h), nv)
    if k > _MAX_K:
        blocks = tuple(_wide_blocks(half0 >> i, k) for i in range(tail))
        return Plan(chunks, tail, tuple((i, 1) for i in range(tail)),
                    blocks, sum(blocks), 1)
    m = 1
    while m < _MAX_PHASE and (2 << m) * k * word_bytes <= _PHASE_BYTES:
        m += 1
    phases = tuple((i, min(m, tail - i)) for i in range(0, tail, m))
    blocks = tuple(b for i, n in phases
                   for b in [_blocks(half0 >> (i + n - 1))] * n)
    return Plan(chunks, tail, phases, blocks, sum(blocks), 1)


def _prove_on_card(name, f, tables, chal, W):
    """K7 for W claims over field ``f``, counted in ``LAUNCHES[name]``:
    tables are k contiguous tensors of W rows of 2^nv words, nv >= 1.
    Returns (msgs [W, nv, k+1], finals [W, k])."""
    p = plan(chal.shape[0], len(tables), tables[0].element_size(), W)
    if len(p.chunks) == 1:
        return _prove_chunk(name, f, tables, chal, W, p)
    parts = [_prove_chunk(name, f, [T[w:w + n] for T in tables], chal, n, p)
             for w, n in p.chunks]
    return tuple(torch.cat(x) for x in zip(*parts))


def _prove_chunk(name, f, tables, chal, W, p):
    """One chunk of W <= 65,535 claims under plan ``p``: one cooperative
    launch."""
    k, nv = len(tables), chal.shape[0]
    half = 1 << (nv - 1)
    dev = tables[0].device
    scratch = torch.empty((W, k, half), dtype=f.dtype, device=dev)
    partials = torch.empty((W * p.rows, k + 1), dtype=f.dtype, device=dev)
    msgs = torch.empty((W, nv, k + 1), dtype=f.dtype, device=dev)
    ins = [T.data_ptr() for T in tables]
    # beyond the launch parameters' pointers, a device array of all k
    more = None if k <= _WIDE_PTRS else torch.tensor(
        ins, dtype=torch.int64).pin_memory().to(dev, non_blocking=True)
    info = (ctypes.c_int * 2)()
    _build.launch(LAUNCHES, name,
                  getattr(_build.kernels(), f"srt_sumcheck_prove_{f.name}"),
                  dev, (ctypes.c_void_p * k)(*ins),
                  None if more is None else more.data_ptr(),
                  scratch.data_ptr(), k, W, half, nv, p.tail,
                  chal.data_ptr(), p.rows, partials.data_ptr(),
                  msgs.data_ptr(), info)
    LAST_GRID[name] = tuple(info)
    return msgs, scratch[:, :, 0]


def _no_rounds(f, tables, *lead):
    """The messages of a proof with no variable: [*lead, 0, k+1]."""
    return torch.empty((*lead, 0, len(tables) + 1), dtype=f.dtype,
                       device=tables[0].device)


def sumcheck_prove_many(tables, challenges, field: str = "goldilocks"):
    """k-ary product sumcheck prover, msb order: ``tables`` k [2^nv]
    storage tensors of ``field``, ``challenges`` nv field elements (a
    1-D storage tensor, or scalars).  Returns (msgs [nv, k+1], finals: k
    0-d tensors).

    The 8-limb stark_prime has no K7: as the reference keeps its XLA
    prover there, this is the generic prover on [2^nv, 8] tables and
    [nv, 8] challenges, on any device (its field ops are the kernels S1
    and S2 on the card)."""
    if field == STARK.name:
        return sumcheck_prove_many_with_challenges(STARK, tables,
                                                   challenges, order="msb")
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
