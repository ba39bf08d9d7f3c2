"""Entry points (counterpart of the reference's root file
``__graft_entry__.py``).

* :func:`entry` -- the flagship single-device step: the Goldilocks
  model's CRT of two batches, their slot-wise product and the ICRT (on
  the card the CRT and ICRT folds are K3), then a base-256 gadget
  decomposition (k = 9) and its recomposition, whose difference with
  the product must be zero.
* :func:`grid_step` -- one step on a 2-D (dp, sp) grid of shards:
  data-parallel batch blocks by sequence-parallel column blocks of the
  sharded four-step NTT (one exchange a transform over each row), the
  product's widened words summed over both axes with
  :func:`~.parallel.psum_words` and folded mod q once.
* :func:`dryrun_multichip` -- every sharded path once at tiny shapes,
  each result held to its local twin: the grid step, the exchange
  kernel K8 against the plain block transpose (Goldilocks and BabyBear,
  ``mul_cached``, ``square``), ``ShardedMLE``'s sumchecks,
  ``ShardedSparseMatVec``, ``ShardedModelMul``, the batch-sharded
  gadget decomposition with the batched psi range check, the
  witness-sharded ``FoldingStep`` and ``FoldingTree`` with its verifier.

A grid is a list of dp row meshes (:func:`make_grid`), each a 1-D
``Mesh`` of sp shards along the axis "sp"; grid data is a list of dp
shard lists, row i holding batch block i and its shard j column block
j, as the reference's ``PartitionSpec("dp", None, "sp")`` lays them
out.  One device holds all n shards; a list of devices gives one shard
each.  Every function runs on the card unless the caller passes
``device="cpu"``; a failed check raises ``AssertionError`` (an explicit
``raise``, which ``python -O`` keeps).

Run:  python -m stark_rings_tpu_torch.entry [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .decomp import decompose_ring, gadget_decompose, recompose_ring
from .device import get_device, to_numpy_storage
from .fields import BABYBEAR, GOLDILOCKS
from .linalg import FieldElems, SparseMatrix
from .mle.sumcheck import sumcheck_prove_many_with_challenges
from .ops.ntt import NTTContext
from .parallel import (ShardedMLE, ShardedModelMul, ShardedNTT,
                       ShardedSparseMatVec, gather, make_mesh, psum_words,
                       shard)
from .parallel.mesh import check_shards, with_index
from .protocol import FoldingStep, FoldingTree
from .rings import get_ring
from .rings.monomial import psi_range_check_batched
from .rings.sampling import sample_short

__all__ = ["entry", "step_stages", "make_grid", "shard_grid",
           "gather_grid", "grid_step", "dryrun_multichip"]

ENTRY_B = 32            # the flagship step's batch
BASE, DIGITS = 256, 9   # its gadget decomposition


def step_stages(ring, a, b) -> dict:
    """The flagship step's stages on coefficient-form [B, D] storage:
    ``prod`` = icrt(crt(a) * crt(b)), its ``digits`` [B, 9, D] at base
    256, their recomposition ``back`` and ``zero`` = prod - back."""
    f = ring.field
    prod = ring.icrt(ring.ntt_mul(ring.crt(a), ring.crt(b)))
    digits = decompose_ring(f, prod, BASE, DIGITS)
    back = recompose_ring(f, digits, BASE)
    return {"prod": prod, "digits": digits, "back": back,
            "zero": ring.add(prod, ring.neg(back))}


def entry(device="cuda"):
    """(step, (a, b)): the Goldilocks model's step at B = 32 and its
    inputs, drawn from ``numpy.random.default_rng(0)``.  ``step(a, b)``
    returns prod - recompose(decompose(prod)), all zeros; it takes any
    batch of coefficient-form [B, 24] storage on the ring's device."""
    ring = get_ring("goldilocks", device)
    rng = np.random.default_rng(0)
    a = ring.rand_coeff((ENTRY_B,), rng)
    b = ring.rand_coeff((ENTRY_B,), rng)

    def step(a, b):
        return step_stages(ring, a, b)["zero"]

    return step, (a, b)


# -- the (dp, sp) grid --------------------------------------------------------


def grid_shape(n_devices: int) -> tuple:
    """n = dp * sp with sp the largest power of two dividing n."""
    n = int(n_devices)
    if n < 1:
        raise ValueError(f"a grid needs at least one shard, got {n}")
    sp = n & -n
    return n // sp, sp


def _devices(n: int, device) -> list:
    """n shard devices: ``device`` n times, or the first n of a list."""
    if isinstance(device, (list, tuple)):
        devs = [with_index(get_device(d)) for d in device]
        if len(devs) < n:
            raise ValueError(f"need {n} devices, have {len(devs)}")
        return devs[:n]
    return [with_index(get_device(device))] * n


def make_grid(n_devices: int, device="cuda") -> list:
    """The dp row meshes of an n-shard (dp, sp) grid, each
    ``make_mesh(sp, axis="sp")``: row i over shards i*sp .. i*sp + sp - 1
    (of one device, or of a list of devices, one shard each)."""
    dp, sp = grid_shape(n_devices)
    devs = _devices(dp * sp, device)
    return [make_mesh(sp, axis="sp", device=devs[i * sp:(i + 1) * sp])
            for i in range(dp)]


def shard_grid(sn, rows, x) -> list:
    """[B, N1, N2] (a storage tensor, or the reference's numpy storage)
    -> dp lists of sp shards: batch block i over row i, its column block
    j on shard j."""
    spec = sn.shard_specs(1)[0]
    blocks = (np.split(x, len(rows)) if isinstance(x, np.ndarray)
              else x.chunk(len(rows)))
    if len(blocks) != len(rows) or x.shape[0] % len(rows):
        raise ValueError(f"a batch of {x.shape[0]} does not split into "
                         f"{len(rows)} rows")
    return [sn.shard(blk, spec, row) for blk, row in zip(blocks, rows)]


def gather_grid(sn, grid, device=None):
    """The grid's shards joined to [B, N1, N2]: the reference's numpy
    storage, or with ``device`` a storage tensor there."""
    spec = sn.shard_specs(1)[0]
    dev = "cpu" if device is None else device
    whole = torch.cat([sn.gather(row, spec, dev) for row in grid])
    return whole if device is not None else to_numpy_storage(whole)


def grid_step(sn, rows, a, b):
    """One (dp, sp) step: each row's negacyclic product through the
    sharded four-step ``sn`` (P = sp, one exchange a transform over the
    row), and the checksum, the sum mod q of every product entry:
    widened words summed on each shard, ``psum_words`` over each row,
    then over the rows' totals, and one ``reduce_words``.

    ``a`` and ``b`` are grid data (:func:`shard_grid`).  Returns (the
    product as grid data, the checksum on the first row's first
    device)."""
    f = sn.f
    if len(a) != len(rows) or len(b) != len(rows):
        raise ValueError(f"expected {len(rows)} rows of shards")
    prods, totals = [], []
    for row, ar, br in zip(rows, a, b):
        sn._check_mesh(row)
        ar = check_shards(row, ar, f.dtype, "a")
        br = check_shards(row, br, f.dtype, "b")
        prod = sn._local_inverse(sn._local_mul(sn._local_forward(ar),
                                               sn._local_forward(br)))
        words = []
        for x in prod:
            w = f.widen(x)
            words.append(w.reshape(-1, w.shape[-1]).sum(dim=0))
        prods.append(prod)
        totals.append(psum_words(words))
    return prods, f.reduce_words(psum_words(totals))


# -- the dry run --------------------------------------------------------------


def _same(what: str, got, want) -> None:
    """Raise unless ``got`` and ``want`` are bit-equal tensors."""
    if got.shape != want.shape or got.dtype != want.dtype \
            or not torch.equal(got, want.to(got.device)):
        raise AssertionError(f"{what}: the sharded result differs from "
                             "its local twin")


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run every sharded path once on n shards at tiny shapes and hold
    each result to its local twin; raises ``AssertionError`` on the
    first mismatch.  ``device``: one device for all n shards (the card
    by default), or a list of devices, one shard each.

    ``ShardedMLE`` and ``FoldingTree.prove_sharded`` need a power-of-two
    shard count: where n is not one, they run on the first 2^floor(log2
    n) shards."""
    n = int(n_devices)
    dp, sp = grid_shape(n)
    devs = _devices(n, device)
    dev = devs[0]
    rng = np.random.default_rng(1)
    f = GOLDILOCKS

    # -- the (dp, sp) grid step ------------------------------------------
    rows = make_grid(n, devs)
    N1 = N2 = max(2 * sp, 4)
    N = N1 * N2
    sn = ShardedNTT("goldilocks", N, sp, axis="sp")
    B = 2 * dp
    a = f.rand((B, N1, N2), rng, dev)
    b = f.rand((B, N1, N2), rng, dev)
    prod, checksum = grid_step(sn, rows, shard_grid(sn, rows, a),
                               shard_grid(sn, rows, b))
    prod = gather_grid(sn, prod, dev)
    ctx = NTTContext(f, N, device=dev)
    want = ctx.mul(a.reshape(B, N), b.reshape(B, N)).reshape(B, N1, N2)
    _same("grid step product", prod, want)
    _same("grid step checksum", checksum,
          f.reduce_words(f.widen(want).reshape(-1, 2).sum(dim=0)))

    # -- the exchange kernel K8 against the plain block transpose ----------
    if sp >= 2:
        mesh_sp = make_mesh(sp, device=devs[:sp])
        for fld in (GOLDILOCKS, BABYBEAR):
            sxp = ShardedNTT(fld.name, N, sp, exchange="pallas")
            sxx = ShardedNTT(fld.name, N, sp)
            spec = sxx.shard_specs(1)[0]
            fp_, ip_, _ = sxp.make_fns(mesh_sp, batch_ndim=1)
            fx_, _, mul_x = sxx.make_fns(mesh_sp, batch_ndim=1)
            xs = sxx.shard(fld.rand((2, N1, N2), rng, dev), spec, mesh_sp)
            fpx = fp_(xs)
            for got, want in zip(fpx, fx_(xs)):
                _same(f"{fld.name} K8 exchange", got, want)
            if fld is GOLDILOCKS:
                pre_c, mulc, sq = sxx.make_cached_fns(mesh_sp, batch_ndim=1)
                ys = sxx.shard(fld.rand((2, N1, N2), rng, dev), spec,
                               mesh_sp)
                for got, want in zip(mulc(xs, pre_c(ys)), mul_x(xs, ys)):
                    _same("sharded mul_cached", got, want)
                for got, want in zip(sq(xs), mul_x(xs, xs)):
                    _same("sharded square", got, want)
            else:
                for got, want in zip(ip_(fpx), xs):
                    _same("babybear K8 roundtrip", got, want)

    # -- the sharded sumcheck provers ---------------------------------------
    p2 = 1 << (n.bit_length() - 1)
    mesh_p2 = make_mesh(p2, device=devs[:p2])
    nv = max(4, (n - 1).bit_length() + 2)
    sm = ShardedMLE(f, nv, mesh_p2)
    G, H, K = (f.rand((1 << nv,), rng, dev) for _ in range(3))
    chals = list(f.rand((nv,), rng, dev))
    msgs, gv, hv = sm.make_sumcheck_fn()(sm.shard(G), sm.shard(H), *chals)
    want_m, want_f = sumcheck_prove_many_with_challenges(f, [G, H], chals)
    _same("sharded sumcheck", msgs, want_m)
    _same("sharded sumcheck finals", torch.stack([gv, hv]),
          torch.stack(want_f))
    msgs3, finals3 = sm.make_sumcheck_many_fn(3)(
        sm.shard(G), sm.shard(H), sm.shard(K), *chals)
    want_m, want_f = sumcheck_prove_many_with_challenges(f, [G, H, K], chals)
    _same("sharded k-ary sumcheck", msgs3, want_m)
    _same("sharded k-ary sumcheck finals", torch.stack(finals3),
          torch.stack(want_f))

    # -- the nnz-sharded sparse mat-vec --------------------------------------
    mesh_n = make_mesh(n, device=devs)
    fe = FieldElems(f, dev)
    sA = SparseMatrix.rand(fe, 4, 8, 0.5, rng)
    sv = f.rand((8,), rng, dev)
    _same("sharded sparse mat-vec",
          ShardedSparseMatVec(fe, mesh_n).mul_vec(sA, sv), sA.mul_vec(sv))

    # -- the batch-sharded model multiply and challenge multiply -------------
    ring = get_ring("goldilocks", dev)
    smm = ShardedModelMul(ring, mesh_n)
    am = ring.rand_coeff((2 * n,), rng)
    bm = ring.rand_coeff((2 * n,), rng)
    got = smm.gather(smm.make_mul_fn()(smm.shard(am), smm.shard(bm)), dev)
    want = ring.icrt(ring.ntt_mul(ring.crt(am), ring.crt(bm)))
    _same("sharded model mul", got, want)
    ch = ring.rand_coeff((1,), rng)
    got = smm.gather(smm.make_challenge_mul_fn()(smm.shard(am), ch), dev)
    want = ring.icrt(ring.ntt_mul(ring.crt(am),
                                  ring.crt(ch).expand_as(want)))
    _same("sharded challenge mul", got, want)

    # -- the batch-sharded gadget decomposition and psi range check (frog) ---
    fr = get_ring("frog", dev)
    sw = sample_short(fr, (n, 2), rng, bound=1)

    def local_checks(x):
        digs = gadget_decompose(fr.field, x, 4, 4)
        return digs, psi_range_check_batched(fr, digs)

    outs = [local_checks(x) for x in shard(sw, mesh_n)]
    digs, ok = local_checks(sw)
    _same("sharded gadget decompose", gather([o[0] for o in outs], 0, dev),
          digs)
    _same("sharded psi range check", gather([o[1] for o in outs], 0, dev),
          ok)
    _check(bool(ok.all()), "short digits must range-check")

    # -- the witness-sharded folding step ------------------------------------
    fs = FoldingStep(ring, n_rows=2, wit_len=2, base=256)
    c = fs.init_tables(rng)
    rt = fs.precompute_challenge(ring.rand_coeff((), rng))
    s0, s1 = fs.rand_witness(n, rng), fs.rand_witness(n, rng)
    c0, c1 = (fs.tm.to_t(ring.rand_ntt((n, 2), rng)).contiguous()
              for _ in range(2))
    o_sh = fs.make_sharded_step_fn(mesh_n)(
        c, *(shard(x, mesh_n, 1) for x in (s0, s1, c0, c1)), rt)
    o_lc = fs.step(c, s0, s1, c0, c1, rt)
    for key in ("s", "c", "digits", "cd", "ok_l2"):
        _same(f"sharded folding step {key}",
              gather(o_sh[key], 0 if key.startswith("ok_") else 1, dev),
              o_lc[key])

    # -- the folding tree, its first levels witness-sharded ------------------
    ft = FoldingTree(ring, n_rows=2, wit_len=2, base=8)
    Wt = 2 * p2
    cT = ft.init_tables(rng)
    wt = ft.rand_witnesses(Wt, rng)
    ct = ft.commit_witnesses(cT, wt)
    rts = ft.precompute_challenges([ring.rand_coeff((), rng)
                                    for _ in range(Wt.bit_length() - 1)])
    lv_l, rw_l, _ = ft.prove(cT, wt, ct, rts)
    lv_s, rw_s, _ = ft.prove_sharded(mesh_p2, cT, wt, ct, rts)
    _same("sharded folding tree root", rw_s, rw_l)
    for lvl, (ol, os_) in enumerate(zip(lv_l, lv_s)):
        for key in ol:
            _same(f"sharded folding tree level {lvl} {key}", os_[key],
                  ol[key])
    _check(ft.verify(cT, wt, ct, lv_s, rts),
           "the folding tree verifier rejected the sharded transcript")


def main(device="cuda") -> None:
    """The step of :func:`entry`, then ``dryrun_multichip(8)``."""
    step, (a, b) = entry(device)
    out = step(a, b)
    _check(not bool(out.any()), "entry: prod - recompose(decompose(prod)) "
           "is not zero")
    print("entry ok", tuple(out.shape))
    dryrun_multichip(8, device)
    print("dryrun ok")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    main(ap.parse_args().device)
