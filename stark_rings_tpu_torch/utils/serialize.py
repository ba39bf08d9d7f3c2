"""Canonical byte serialization (counterpart of
``stark_rings_tpu/utils/serialize.py``; reference: arkworks
CanonicalSerialize of ring elements coeff_form.rs:154-189, matrices
matrix.rs:111-145, MLEs dense.rs:17).

The arkworks layouts: a field element is its canonical integer,
little-endian, in ceil(bits / 8) bytes (:func:`elem_nbytes` and
:func:`elements_to_bytes`, shared with the transcript in
:mod:`..rings.absorb`); a ring element is its D values; a Vec is a u64
LE length and then its items; usize is u64 LE; a tuple is its fields in
order; a BTreeMap is a u64 LE length and then its (key, value) pairs in
ascending key order.  Fields are written in declaration order:

  Matrix        = Vec<Vec<R>>                    (matrix.rs:111-145)
  SymmetricMatrix = Vec<Vec<R>>, row i of i+1    (symmetric_matrix.rs:116-130)
  SparseMatrix  = u64 nrows, u64 ncols,
                  Vec<Vec<(R, usize)>>           (sparse_matrix.rs:158-199)
  DenseMLE      = Vec<R> evals (trailing zeros cut), u64 num_vars,
                  u64 elen, R zero               (dense.rs:17-24)
  SparseMLE     = BTreeMap<u64, R>, u64 num_vars, R zero  (sparse.rs:24-31)

Modes (arkworks Compress / Validate, serialize.rs):

* ``compress``: a prime-field container has no point compression, so the
  compressed and uncompressed streams are the same bytes.  The flag is
  taken and changes nothing, as in the reference.
* ``validate``: ``False`` skips the structural checks (symmetric row
  lengths, elen == 2^num_vars, the outer Vec's count); every element
  read is still checked canonical (< q), as ark-ff's ``from_bigint``
  does whatever the flag.  A failed check raises ``ValueError``.

Host code: elements are decoded to Python ints to write them, and read
bytes are encoded onto the adapter's device (the card unless the
adapter was built for the CPU).
"""

from __future__ import annotations

import struct

import numpy as np

from ..rings.absorb import elem_nbytes, elements_to_bytes

__all__ = [
    "elem_nbytes", "elements_to_bytes", "elements_from_bytes",
    "vec_to_bytes", "vec_from_bytes",
    "matrix_to_bytes", "matrix_from_bytes",
    "symmetric_matrix_to_bytes", "symmetric_matrix_from_bytes",
    "sparse_matrix_to_bytes", "sparse_matrix_from_bytes",
    "dense_mle_to_bytes", "dense_mle_from_bytes",
    "sparse_mle_to_bytes", "sparse_mle_from_bytes",
    "serialize_compressed", "serialize_uncompressed",
    "deserialize_compressed", "deserialize_compressed_unchecked",
    "deserialize_uncompressed", "deserialize_uncompressed_unchecked",
]


def _u64(*vals) -> bytes:
    return struct.pack(f"<{len(vals)}Q", *vals)


class _Reader:
    """A cursor over a byte string: u64s and canonical field elements."""

    def __init__(self, f, data: bytes, width: int = 1):
        self.f, self.data, self.width, self.off = f, data, width, 0
        self.nb = elem_nbytes(f)

    def u64(self) -> int:
        if self.off + 8 > len(self.data):
            raise ValueError("short buffer")
        (v,) = struct.unpack_from("<Q", self.data, self.off)
        self.off += 8
        return v

    def elem(self) -> tuple:
        """One element: ``width`` canonical ints."""
        nb, end = self.nb, self.off + self.width * self.nb
        if end > len(self.data):
            raise ValueError("short buffer")
        out = tuple(int.from_bytes(self.data[o:o + nb], "little")
                    for o in range(self.off, end, nb))
        if any(v >= self.f.q for v in out):
            raise ValueError("non-canonical field element")
        self.off = end
        return out


def _check(validate: bool, ok: bool, what: str) -> None:
    if validate and not ok:
        raise ValueError(f"invalid structure: {what}")


def elements_from_bytes(f, data: bytes, shape, compress: bool = True,
                        validate: bool = True, device="cuda"):
    """Canonical LE elements, row-major, no header -> a storage tensor of
    ``shape`` on ``device``."""
    count = int(np.prod(shape, dtype=np.int64)) if shape else 1
    r = _Reader(f, data)
    out = np.array([r.elem()[0] for _ in range(count)], dtype=object)
    return f.encode(out.reshape(shape) if shape else out[0], device)


def vec_to_bytes(f, x, n: int, compress: bool = True) -> bytes:
    """u64 LE length prefix + elements (the arkworks Vec layout)."""
    return _u64(n) + elements_to_bytes(f, x)


def vec_from_bytes(f, data: bytes, elem_shape=(), compress: bool = True,
                   validate: bool = True, device="cuda"):
    """-> (n, storage tensor [n]+elem_shape on ``device``)."""
    (n,) = struct.unpack_from("<Q", data, 0)
    return n, elements_from_bytes(f, data[8:], (n,) + tuple(elem_shape),
                                  device=device)


# ---------------------------------------------------------------------------
# structure codecs (the arkworks layouts above)
# ---------------------------------------------------------------------------


def _width(elems) -> int:
    """Field values an element: D for ring adapters, else 1."""
    ring = getattr(elems, "ring", None)
    return ring.D if ring is not None else 1


def _elem_bytes(elems, x) -> list:
    """Each element of storage ``x`` [n]+elem as its bytes."""
    raw = elements_to_bytes(elems.f, x)
    step = _width(elems) * elem_nbytes(elems.f)
    return [raw[i:i + step] for i in range(0, len(raw), step)]


def _elem_ints(elems, x) -> list:
    """Each element of ``x`` as a tuple of ``width`` canonical ints."""
    vals = np.asarray(elems.decode(x), dtype=object).reshape(-1)
    w = _width(elems)
    return [tuple(int(v) for v in vals[i:i + w])
            for i in range(0, len(vals), w)]


def _encode(elems, int_rows):
    """Element int tuples -> storage [n(, D)(, L)] on the adapter's
    device."""
    w = _width(elems)
    arr = np.array([list(r) for r in int_rows], dtype=object).reshape(
        len(int_rows), w)
    return elems.encode(arr if w > 1 else arr[:, 0])


def _zero_elem(elems) -> bytes:
    return bytes(_width(elems) * elem_nbytes(elems.f))


def matrix_to_bytes(mat, compress: bool = True) -> bytes:
    """Matrix -> Vec<Vec<R>>: u64 nrows, then per row u64 ncols and its
    elements."""
    raw = elements_to_bytes(mat.e.f, mat.vals)
    row = len(raw) // max(mat.nrows, 1)
    return _u64(mat.nrows) + b"".join(
        _u64(mat.ncols) + raw[r * row:(r + 1) * row]
        for r in range(mat.nrows))


def matrix_from_bytes(elems, data: bytes, compress: bool = True,
                      validate: bool = True):
    from ..linalg import Matrix

    r = _Reader(elems.f, data, _width(elems))
    nrows, ncols, rows = r.u64(), 0, []
    for i in range(nrows):
        n = r.u64()
        _check(validate, i == 0 or n == ncols, "ragged matrix rows")
        ncols = n
        rows += [r.elem() for _ in range(n)]
    vals = _encode(elems, rows)
    return Matrix(elems, vals.reshape((nrows, ncols) + vals.shape[1:]))


def symmetric_matrix_to_bytes(sym, compress: bool = True) -> bytes:
    """SymmetricMatrix -> the packed lower-triangular rows as
    Vec<Vec<F>>, row i holding i+1 entries."""
    elems = _elem_bytes(sym.e, sym.vals)
    out, k = [_u64(sym.n)], 0
    for i in range(sym.n):
        out.append(_u64(i + 1))
        out += elems[k:k + i + 1]
        k += i + 1
    return b"".join(out)


def symmetric_matrix_from_bytes(elems, data: bytes, compress: bool = True,
                                validate: bool = True):
    from ..linalg import SymmetricMatrix

    r = _Reader(elems.f, data, _width(elems))
    n, flat = r.u64(), []
    for i in range(n):
        rl = r.u64()
        _check(validate, rl == i + 1, f"row {i} must have {i + 1} entries")
        flat += [r.elem() for _ in range(rl)]
    return SymmetricMatrix(elems, n, _encode(elems, flat))


def sparse_matrix_to_bytes(sp, compress: bool = True) -> bytes:
    """SparseMatrix -> u64 nrows, u64 ncols, Vec<Vec<(R, u64 col)>>.

    Entries go out in (row, col) order; all-zero (padding) entries are
    dropped: the reference stores no structural zero."""
    vals = _elem_ints(sp.e, sp.data)
    elems = _elem_bytes(sp.e, sp.data)
    rows, cols = sp.rows.cpu().tolist(), sp.cols.cpu().tolist()
    per_row = [[] for _ in range(sp.nrows)]
    for i in range(sp.nnz):
        if any(vals[i]):
            per_row[rows[i]].append((cols[i], i))
    out = [_u64(sp.nrows, sp.ncols, sp.nrows)]
    for row in per_row:
        row.sort()
        out.append(_u64(len(row)))
        for col, i in row:
            out += [elems[i], _u64(col)]
    return b"".join(out)


def sparse_matrix_from_bytes(elems, data: bytes, compress: bool = True,
                             validate: bool = True):
    from ..linalg import SparseMatrix

    r = _Reader(elems.f, data, _width(elems))
    nrows, ncols, outer = r.u64(), r.u64(), r.u64()
    _check(validate, outer == nrows, f"{outer} rows listed for {nrows}")
    rr, cc, vals = [], [], []
    for row in range(nrows):
        for _ in range(r.u64()):
            vals.append(r.elem())
            rr.append(row)
            cc.append(r.u64())
    if not vals:            # one zero padding entry
        rr, cc, vals = [0], [0], [(0,) * _width(elems)]
    return SparseMatrix(elems, nrows, ncols, _encode(elems, vals),
                        np.array(rr, np.int32), np.array(cc, np.int32))


def dense_mle_to_bytes(mle, compress: bool = True) -> bytes:
    """DenseMLE -> Vec<R> (trailing zeros cut), u64 num_vars, u64 elen,
    R zero."""
    vals = _elem_ints(mle.e, mle.evals)
    elems = _elem_bytes(mle.e, mle.evals)
    last = max((i + 1 for i, v in enumerate(vals) if any(v)), default=0)
    return b"".join([_u64(last), *elems[:last],
                     _u64(mle.num_vars, 1 << mle.num_vars),
                     _zero_elem(mle.e)])


def dense_mle_from_bytes(elems, data: bytes, compress: bool = True,
                         validate: bool = True):
    from ..mle import DenseMLE

    r = _Reader(elems.f, data, _width(elems))
    rows = [r.elem() for _ in range(r.u64())]
    num_vars, elen = r.u64(), r.u64()
    _check(validate, elen == 1 << num_vars,
           f"elen {elen} for {num_vars} variables")
    rows += [(0,) * _width(elems)] * (elen - len(rows))
    return DenseMLE(elems, num_vars, _encode(elems, rows))


def sparse_mle_to_bytes(mle, compress: bool = True) -> bytes:
    """SparseMLE -> BTreeMap<u64, R> (ascending keys, duplicates added,
    zeros dropped), u64 num_vars, R zero."""
    vals = _elem_ints(mle.e, mle.values)
    q = mle.e.f.q
    acc = {}
    for k, v in zip(mle.indices.cpu().tolist(), vals):
        if any(v):
            cur = acc.get(k)
            acc[k] = v if cur is None else tuple(
                (a + b) % q for a, b in zip(cur, v))
    acc = {k: v for k, v in acc.items() if any(v)}
    nb = elem_nbytes(mle.e.f)
    out = [_u64(len(acc))]
    for k in sorted(acc):
        out += [_u64(k), b"".join(v.to_bytes(nb, "little")
                                  for v in acc[k])]
    out += [_u64(mle.num_vars), _zero_elem(mle.e)]
    return b"".join(out)


def sparse_mle_from_bytes(elems, data: bytes, compress: bool = True,
                          validate: bool = True):
    from ..mle import SparseMLE

    r = _Reader(elems.f, data, _width(elems))
    keys, vals = [], []
    for _ in range(r.u64()):
        keys.append(r.u64())
        vals.append(r.elem())
    num_vars = r.u64()
    if not vals:            # one zero padding entry
        keys, vals = [0], [(0,) * _width(elems)]
    return SparseMLE(elems, num_vars, np.array(keys, np.int64),
                     _encode(elems, vals))


# ---------------------------------------------------------------------------
# the arkworks entry points (serialize.rs: serialize_compressed /
# serialize_uncompressed / deserialize_{compressed,uncompressed}[_unchecked])
# ---------------------------------------------------------------------------

_TO_BYTES = {
    "Matrix": matrix_to_bytes,
    "SymmetricMatrix": symmetric_matrix_to_bytes,
    "SparseMatrix": sparse_matrix_to_bytes,
    "DenseMLE": dense_mle_to_bytes,
    "SparseMLE": sparse_mle_to_bytes,
}

_FROM_BYTES = {
    "Matrix": matrix_from_bytes,
    "SymmetricMatrix": symmetric_matrix_from_bytes,
    "SparseMatrix": sparse_matrix_from_bytes,
    "DenseMLE": dense_mle_from_bytes,
    "SparseMLE": sparse_mle_from_bytes,
}


def _dispatch_to(obj, compress: bool) -> bytes:
    fn = _TO_BYTES.get(type(obj).__name__)
    if fn is None:
        raise TypeError(f"no codec for {type(obj).__name__}")
    return fn(obj, compress=compress)


def _dispatch_from(cls, elems, data: bytes, compress: bool, validate: bool):
    name = cls if isinstance(cls, str) else cls.__name__
    fn = _FROM_BYTES.get(name)
    if fn is None:
        raise TypeError(f"no codec for {name}")
    return fn(elems, data, compress=compress, validate=validate)


def serialize_compressed(obj) -> bytes:
    return _dispatch_to(obj, compress=True)


def serialize_uncompressed(obj) -> bytes:
    return _dispatch_to(obj, compress=False)


def deserialize_compressed(cls, elems, data: bytes):
    return _dispatch_from(cls, elems, data, compress=True, validate=True)


def deserialize_compressed_unchecked(cls, elems, data: bytes):
    return _dispatch_from(cls, elems, data, compress=True, validate=False)


def deserialize_uncompressed(cls, elems, data: bytes):
    return _dispatch_from(cls, elems, data, compress=False, validate=True)


def deserialize_uncompressed_unchecked(cls, elems, data: bytes):
    return _dispatch_from(cls, elems, data, compress=False, validate=False)
