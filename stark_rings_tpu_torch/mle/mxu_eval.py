"""Dense-MLE full evaluation as two exact int8 digit GEMMs (counterpart
of ``stark_rings_tpu/mle/mxu_eval.py``).

A full evaluation of a 2^nv table T at (r_0 .. r_{nv-1}) factors through
T as a matrix M = T.reshape(2^(nv-hl), 2^hl) (row = high bits):

    eval = u^T M v,   v[c] = prod_{j<hl} eq(bit_j(c), r_j),
                      u[r] = prod_{j>=hl} eq(bit_{j-hl}(r), r_j).

Each contraction is exact in int32 through digit planes: the eq vector
is prescaled by 2^(8l) (unsigned scheme) or 2^(7l) (signed scheme) per
data plane and cut into digits at run time, the table into bytes.  The
products go to ``torch._int_mm`` (int8 only), as the reference leaves
them to XLA's dot.  The unsigned u8 x u8 scheme uses the offset
identity of ``ops/mxu2.py``; the signed scheme (contractions longer than
``_U8_MAX_R``) calls ``_int_mm`` directly.  ``_int_mm`` on CUDA wants
more than 16 rows and multiples of 8 elsewhere, so operands are padded
with zeros, which add nothing to the product.
"""

from __future__ import annotations

import torch

from ..fields.field import GOLDILOCKS as _f, MASK32, shr
from ..ops.mxu2 import (B_BITS, D_BITS, K_BUCKETS, K_BUCKETS_U8, P_PLANES,
                        P_PLANES_U8, _mm)
from .fix import as_points

__all__ = ["evaluate_goldilocks_mxu", "evaluate_many_goldilocks_mxu",
           "fix_last_variables_mxu"]

_Q = _f.q

#: longest contraction the unsigned u8 x u8 scheme takes (int32 bucket
#: bound P * R * 255^2 < 2^31); longer ones use the signed 7-bit scheme
_U8_MAX_R = (2**31 - 1) // (P_PLANES_U8 * 255 * 255)


def _bias_bits(R):
    """Bucket bias exponent for contraction length R in the signed
    scheme (|V_k| <= P * R * 127 * 128 < 2^bits)."""
    if P_PLANES * R * 127 * 128 >= 2**31:
        raise ValueError(f"contraction of {R} too long for int32 buckets")
    return (P_PLANES * R * 127 * 128).bit_length()


def _eq_vector(pts):
    """[2^h] little-endian eq vector: w[c] = prod_j eq(bit_j(c), r_j);
    ``pts`` an int64 tensor [h]."""
    one = _f.ones((), pts.device)
    w = _f.ones((1,), pts.device)
    for r in pts:                 # each new point becomes the next bit up
        w = torch.cat([_f.mul(w, _f.sub(one, r)), _f.mul(w, r)])
    return w


def _eq_rows(P):
    """[W, h] points -> [W, 2^h] eq vectors."""
    one = _f.ones((), P.device)
    w = _f.ones((P.shape[0], 1), P.device)
    for j in range(P.shape[1]):
        r = P[:, j:j + 1]
        w = torch.cat([_f.mul(w, _f.sub(one, r)), _f.mul(w, r)], dim=1)
    return w


def _bytes(x, k):
    """Byte k of u64 bit patterns, as int64 in [0, 256)."""
    return shr(x, 8 * k) & 0xFF if k else x & 0xFF


def _digitize_signed(x):
    """canonical [n] -> int8 [K, n] with x = sum_k d_k 2^(8k)."""
    outs = []
    carry = torch.zeros_like(x)
    for k in range(K_BUCKETS - 1):
        m = _bytes(x, k) + carry
        ge = (m >= 128).to(torch.int64)
        outs.append((m - 256 * ge).to(torch.int8))
        carry = ge
    outs.append(carry.to(torch.int8))    # x >> 64 is 0: the top digit
    return torch.stack(outs)


def _weights(u):
    """canonical [n] -> prescaled signed planes int8 [K, P*n]: column
    block l holds digitize(u * 2^(7l) mod q)."""
    return torch.cat([_digitize_signed(
        _f.mul(u, _f.const(pow(2, D_BITS * l, _Q), u.device)))
        for l in range(P_PLANES)], dim=1)


def _planes(x):
    """u64 [R, C] -> int8 [P*R, C] of 7-bit digit planes (l-major)."""
    return torch.cat([((shr(x, D_BITS * l) if l else x) & 0x7F)
                      .to(torch.int8) for l in range(P_PLANES)], dim=0)


def _weights_u8_rows(U):
    """canonical [W, n] -> uint8 [K8*W, P8*n]: row block k holds digit k
    of every row's weights prescaled by 2^(8l) in column block l."""
    blocks = []
    for l in range(P_PLANES_U8):
        s = _f.mul(U, _f.const(pow(2, 8 * l, _Q), U.device))
        blocks.append(torch.cat([_bytes(s, k).to(torch.uint8)
                                 for k in range(K_BUCKETS_U8)], dim=0))
    return torch.cat(blocks, dim=1)


def _weights_u8(u):
    """canonical [n] -> prescaled unsigned planes uint8 [K8, P8*n]."""
    return _weights_u8_rows(u[None, :])


def _planes_u8(x):
    """u64 [R, C] -> uint8 [P8*R, C] of 8-bit digit planes (l-major)."""
    return torch.cat([_bytes(x, l).to(torch.uint8)
                      for l in range(P_PLANES_U8)], dim=0)


def _mm_u8(W, X):
    """Exact uint8 [m, k] @ uint8 [k, n] -> int32, by the offset identity
    sum W X = mm(W-128, X-128) + 128 colsum(X-128) + 128 rowsum(W-128)
    + 128^2 k (the true sum is below 2^31; the terms add in int64)."""
    ws = (W ^ 0x80).view(torch.int8)
    xs = (X ^ 0x80).view(torch.int8)
    V = _mm(ws, xs).to(torch.int64)
    V += 128 * xs.sum(0, dtype=torch.int64)[None, :]
    V += 128 * ws.sum(1, dtype=torch.int64)[:, None]
    V += 128 * 128 * W.shape[1]
    return V.to(torch.int32)


def _fold(V, bias_bits=None):
    """int32 [K, C] buckets -> canonical [C], value sum_k V_k 2^(8k).

    Signed scheme (``bias_bits`` set): each bucket is biased by
    2^bias_bits first and the bias sum subtracted mod q at the end."""
    K = V.shape[0]
    if bias_bits is None:
        n_words = (B_BITS * (K - 1) + 31) // 32 + 1
    else:
        n_words = (B_BITS * (K - 1) + bias_bits + 1) // 32 + 1
    words = [None] * (n_words + 1)
    for k in range(K):
        v = V[k].to(torch.int64)
        if bias_bits is not None:
            v = v + (1 << bias_bits)
        r = B_BITS * k
        j, sh = r >> 5, r & 31
        contrib = v << sh
        lo = contrib & MASK32
        hi = shr(contrib, 32)
        words[j] = lo if words[j] is None else words[j] + lo
        words[j + 1] = hi if words[j + 1] is None else words[j + 1] + hi
    zero = torch.zeros_like(words[0])
    words = [w if w is not None else zero for w in words]
    digits = []
    carry = zero
    for w in words:
        t = w + carry
        digits.append(t & MASK32)
        carry = shr(t, 32)
    digits.append(carry)
    while len(digits) < 4:
        digits.append(zero)
    A = digits[0] | (digits[1] << 32)
    Bw = digits[2] | (digits[3] << 32)
    acc = _f._reduce128(Bw, A)
    if bias_bits is None:
        return acc
    bias = sum((1 << bias_bits) << (B_BITS * k) for k in range(K)) % _Q
    return _f.sub(acc, _f.const(bias, V.device))


def _contract(u, M):
    """sum_r u[r] M[r, :] mod q, exact: canonical [C]."""
    R = M.shape[0]
    if R <= _U8_MAX_R:
        return _fold(_mm_u8(_weights_u8(u), _planes_u8(M)))
    return _fold(_mm(_weights(u), _planes(M)), _bias_bits(R))


def fix_last_variables_mxu(evals, pts_high):
    """Bind the highest len(pts_high) variables in one contraction:
    ``evals`` canonical [2^nv] -> the [2^(nv-h)] table of the low
    variables, equal to ``DenseMLE.fix_last_variables(pts_high)``."""
    pts = as_points(pts_high, evals.device)
    h = pts.shape[0]
    n = evals.shape[0]
    R = 1 << h
    C = n // R
    if R * C != n:
        raise ValueError(f"cannot fix {h} variables of a table of {n}")
    if R < 8:
        # one or two halving passes are cheaper than the digit GEMM
        ev = evals
        for r in reversed(list(pts)):
            half = ev.shape[0] // 2
            left, right = ev[:half], ev[half:]
            ev = _f.add(left, _f.mul(r, _f.sub(right, left)))
        return ev
    return _contract(_eq_vector(pts), evals.reshape(R, C))


def evaluate_many_goldilocks_mxu(evals, pts_batch):
    """Evaluate one dense MLE at W points sharing the table read:
    Y = U M for all points in one contraction, then per point the
    row-column product.  ``pts_batch``: int64 [W, nv] (or nested
    lists).  Returns canonical [W]."""
    P = pts_batch if isinstance(pts_batch, torch.Tensor) else \
        torch.stack([as_points(p, evals.device) for p in pts_batch])
    P = P.to(evals.device)
    W, nv = P.shape
    if tuple(evals.shape) != (1 << nv,):
        raise ValueError(f"table of {tuple(evals.shape)} for {nv} points")
    if nv < 4:
        return _f.sum(_f.mul(evals[None, :], _eq_rows(P)), axis=1)
    hl = nv // 2
    C = 1 << hl
    R = (1 << nv) // C
    if R > _U8_MAX_R or C > _U8_MAX_R:
        raise ValueError("point-batched evaluation takes tables to 2^24")
    M = evals.reshape(R, C)
    U = _eq_rows(P[:, hl:])                                   # [W, R]
    Vv = _eq_rows(P[:, :hl])                                  # [W, C]
    Vb = _mm_u8(_weights_u8_rows(U), _planes_u8(M))           # [K8*W, C]
    Y = _fold(Vb.reshape(K_BUCKETS_U8, W * C)).reshape(W, C)
    # eval[w] = sum_c Y[w, c] Vv[w, c]: digits of Y rowwise, contract C
    yp = torch.cat([_bytes(Y, l) for l in range(P_PLANES_U8)],
                   dim=1)                                     # [W, P8*C]
    wv = _weights_u8_rows(Vv).to(torch.int64).reshape(
        K_BUCKETS_U8, W, P_PLANES_U8 * C)                     # [K8, W, P8*C]
    V2 = (wv * yp[None]).sum(-1).to(torch.int32)              # exact
    return _fold(V2)


def evaluate_goldilocks_mxu(evals, pts):
    """Full evaluation of a dense Goldilocks MLE at one point: canonical
    0-d tensor, equal to ``DenseMLE.evaluate``."""
    pts = as_points(pts, evals.device)
    nv = pts.shape[0]
    if tuple(evals.shape) != (1 << nv,):
        raise ValueError(f"table of {tuple(evals.shape)} for {nv} points")
    if nv < 4:
        return _f.sum(_f.mul(evals, _eq_vector(pts)), axis=0)
    hl = nv // 2
    C = 1 << hl
    R = (1 << nv) // C
    y = _contract(_eq_vector(pts[hl:]), evals.reshape(R, C))   # [C]
    return _contract(_eq_vector(pts[:hl]), y[:, None])[0]
