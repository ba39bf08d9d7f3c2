"""Deg-2^16 Goldilocks negacyclic ring multiply as two 256x256 modular
matmul levels with pre-scaled 8-bit digit weights (counterpart of
``stark_rings_tpu/ops/mxu2.py``).

:class:`Mxu2NTT` here is the plain, kernel-free whole multiply: the
digit GEMMs go to ``torch._int_mm`` and every fold, twiddle and slot
product is plain tensor code.  ``ops/fold.py`` subclasses it with the
fold epilogues in hand-written CUDA kernels.

Layouts (B = batch), as in the reference:
  coeff domain   [B, N],  N = N1*N2, n = n1*N2 + n2
  internal       [n1, B, n2]  (contraction axis leading)
  NTT domain     [k2, B, k1]  — a fixed frequency order shared by the
  slot product and the inverse, so ring multiplication is exact.

The digit GEMM keeps the reference's default unsigned scheme (u8 data
digits times u8 weight digits, K = P = 8), so the int32 buckets the fold
kernels receive are the reference's byte for byte.  ``torch._int_mm``
takes int8 only; with ``s = d - 128`` and ``w_s = W - 128`` (both as
int8) the exact identity

    sum_c W[r,c] d[c,j] = _int_mm(w_s, s)[r,j] + 128 sum_c s[c,j]
                          + 128 sum_c w_s[r,c] + 128^2 (P*C)

holds in int32 (every term and the result stay below 2^31).  The
row-constant part is precomputed with the table, and the column sums
come out of the same GEMM through a row of ones appended to the table.
The signed scheme
(``unsigned=False``: ten 7-bit data planes times nine signed weight
digits) calls ``_int_mm`` directly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import get_device, to_torch
from ..fields.field import GOLDILOCKS, MASK32, shr
from .ntt import find_primitive_root

__all__ = ["Mxu2NTT", "PrescaledMat", "from_jax_consts", "BIAS_MOD_Q"]

_f = GOLDILOCKS
_Q = _f.q

P_PLANES = 10   # 7-bit unsigned data digits covering 64 bits
D_BITS = 7
K_BUCKETS = 9   # signed 8-bit weight digits covering [0, q)
B_BITS = 8

P_PLANES_U8 = 8
D_BITS_U8 = 8
K_BUCKETS_U8 = 8

# signed scheme: every bucket is biased by 2^26 before the fold, and this
# constant (sum_k 2^26 2^(8k) mod q) is subtracted afterwards
BIAS_MOD_Q = sum((1 << 26) << (B_BITS * k) for k in range(K_BUCKETS)) % _Q

_WEIGHT_KEYS = ("w1", "w2", "w2i", "w1i")


def _pow_table(base: int, n: int) -> np.ndarray:
    """[base^0, ..., base^(n-1)] mod q as an object array of ints."""
    out = np.empty(n, dtype=object)
    v = 1
    for i in range(n):
        out[i] = v
        v = v * base % _Q
    return out


class PrescaledMat:
    """Constant [R, C] Goldilocks matrix with pre-scaled 8-bit digit planes.

    ``big`` is a numpy array, byte-equal to the reference's: uint8
    [K*R, P*C] for the unsigned scheme, int8 for the signed one.
    """

    def __init__(self, m_ints, unsigned: bool = True):
        m = np.asarray(m_ints, dtype=object)
        R, C = m.shape
        self.R, self.C = R, C
        self.unsigned = unsigned
        self.K = K_BUCKETS_U8 if unsigned else K_BUCKETS
        self.P = P_PLANES_U8 if unsigned else P_PLANES
        self.d_bits = D_BITS_U8 if unsigned else D_BITS
        if unsigned:
            # int32 accumulation bound: P*C products of <= 255*255
            assert P_PLANES_U8 * C * 255 * 255 < 2**31
            big = np.zeros((K_BUCKETS_U8 * R, P_PLANES_U8 * C),
                           dtype=np.uint8)
            for l in range(P_PLANES_U8):
                scale = pow(2, D_BITS_U8 * l, _Q)
                v = ((m * scale) % _Q).astype(np.uint64)
                for k in range(K_BUCKETS_U8):
                    big[k * R:(k + 1) * R, l * C:(l + 1) * C] = (
                        (v >> np.uint64(8 * k))
                        & np.uint64(0xFF)).astype(np.uint8)
            self.big = big
            return
        # int32 accumulation bound: P*C products of |.| <= 128*127
        assert P_PLANES * C * 128 * 127 < 2**31
        big = np.zeros((K_BUCKETS * R, P_PLANES * C), dtype=np.int8)
        for l in range(P_PLANES):
            scale = pow(2, D_BITS * l, _Q)
            v = ((m * scale) % _Q).astype(np.uint64)
            carry = np.zeros((R, C), dtype=np.int16)
            for k in range(K_BUCKETS - 1):
                byte = ((v >> np.uint64(8 * k))
                        & np.uint64(0xFF)).astype(np.int16) + carry
                carry = (byte >= 128).astype(np.int16)
                big[k * R:(k + 1) * R, l * C:(l + 1) * C] = (
                    byte - 256 * carry).astype(np.int8)
            # v < 2^64 so the top digit is exactly the final carry
            big[(K_BUCKETS - 1) * R:, l * C:(l + 1) * C] = \
                carry.astype(np.int8)
        self.big = big

    # -- data digits ----------------------------------------------------------
    def _planes(self, x: torch.Tensor, xor: int = 0) -> torch.Tensor:
        """u64 [C, cols] -> digit planes [P*C, cols], column-major
        (stride (1, P*C)): the layout ``_int_mm`` takes on every backend
        for its second operand.  Plane ``l`` holds bits
        [d_bits*l, d_bits*(l+1)) of each value.

        Unsigned scheme: the 8-bit digits are the little-endian bytes of
        the u64 words, each XORed with ``xor``: one u64 transpose, then
        one byte gather within each row of C words."""
        C, cols = x.shape
        if self.unsigned:
            buf = torch.empty((cols, self.P, C), dtype=torch.uint8,
                              device=x.device)
            by = x.t().contiguous().view(torch.uint8).view(cols, C, 8)
            torch.bitwise_xor(by.permute(0, 2, 1), xor, out=buf)
        else:
            buf = torch.empty((cols, self.P, C), dtype=torch.int8,
                              device=x.device)
            xt = x.t()
            for l in range(self.P):
                sh = self.d_bits * l
                buf[:, l, :] = (shr(xt, sh) if sh else xt) & 0x7F
        return buf.view(cols, self.P * C).t()

    def planes(self, x: torch.Tensor) -> torch.Tensor:
        """u64 [C, cols] -> uint8/int8 [P*C, cols] of 8/7-bit digits
        (the reference's ``planes``; column-major)."""
        return self._planes(x)

    def dot(self, x: torch.Tensor, w: torch.Tensor,
            w_corr: torch.Tensor | None = None) -> torch.Tensor:
        """u64 [C, cols] -> int32 bucket planes [K*R, cols].

        ``w`` and ``w_corr`` are this matrix's device table and, for the
        unsigned scheme, its offset correction (see
        :func:`from_jax_consts`)."""
        if not self.unsigned:
            return torch._int_mm(w, self._planes(x))
        s = self._planes(x, 0x80).view(torch.int8)   # d ^ 0x80 = d - 128
        KR = self.K * self.R
        V = torch._int_mm(w, s)    # row K*R: the ones row, sum_c s[c, j]
        V, colsum = V[:KR], V[KR]
        V += w_corr
        V += 128 * colsum
        return V

    def fold(self, V: torch.Tensor) -> torch.Tensor:
        """int32 [K*R, cols] bucket planes -> canonical u64 [R, cols].

        value = sum_k V_k 2^(8k).  Signed scheme: bias each bucket by
        2^26 (making the packing unsigned) and subtract the constant
        bias afterwards mod q.  Unsigned scheme: no bias."""
        R, K = self.R, self.K
        n_words = (B_BITS * (K - 1) + 31) // 32 + 1
        words = [None] * (n_words + 1)
        for k in range(K):
            v = V[k * R:(k + 1) * R].to(torch.int64)
            if not self.unsigned:
                v = v + (1 << 26)
            r = B_BITS * k
            j, sh = r >> 5, r & 31
            contrib = v << sh
            lo = contrib & MASK32
            hi = shr(contrib, 32)
            words[j] = lo if words[j] is None else words[j] + lo
            words[j + 1] = hi if words[j + 1] is None else words[j + 1] + hi
        zero = torch.zeros_like(words[0])
        words = [w if w is not None else zero for w in words]
        # carry-normalize to digits < 2^32
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
        if self.unsigned:
            return acc
        return _f.sub(acc, BIAS_MOD_Q)


def from_jax_consts(consts: dict, device) -> dict[str, torch.Tensor]:
    """The reference's (or :meth:`Mxu2NTT.consts`') numpy tables ->
    the port's device tables.

    * ``w1``/``w2``/``w2i``/``w1i``: int8 [K*R, P*C], the form
      ``_int_mm`` takes.  A uint8 (unsigned-scheme) table is stored as
      ``W ^ 0x80`` viewed as int8 (``W - 128``), followed by a row of
      ones and 7 rows of zeros ([K*R + 8, P*C]), so that the GEMM also
      returns the data digits' column sums.  It gets a second entry
      ``<key>_corr``: int32 [K*R, 1] = 128 sum_c (W - 128)[r, c]
      + 128^2 (P*C), the row-constant part of the offset identity.
    * ``tw``/``twi``: int64 tensors holding the u64 twiddles.
    """
    dev = get_device(device)
    out = {}
    for key in _WEIGHT_KEYS:
        big = np.asarray(consts[key])
        if big.dtype == np.uint8:
            ws = (big ^ np.uint8(0x80)).view(np.int8)
            corr = (128 * ws.sum(axis=1, dtype=np.int64)
                    + 128 * 128 * big.shape[1]).astype(np.int32)
            extra = np.zeros((8, big.shape[1]), dtype=np.int8)
            extra[0] = 1
            out[key] = torch.from_numpy(np.concatenate([ws, extra])).to(dev)
            out[key + "_corr"] = torch.from_numpy(corr[:, None]).to(dev)
        elif big.dtype == np.int8:
            out[key] = torch.from_numpy(big.copy()).to(dev)
        else:
            raise TypeError(f"{key}: expected a uint8 or int8 digit table, "
                            f"got {big.dtype}")
    for key in ("tw", "twi"):
        out[key] = to_torch(np.asarray(consts[key], dtype=np.uint64), dev)
    return out


class Mxu2NTT:
    """Negacyclic ring multiply for N = N1*N2 (default 256*256 = 2^16).

    The tables are built on the host with numpy, byte-equal to the
    reference's :meth:`consts`, and moved to ``device`` once, here."""

    F = _f  # the field whose modulus the twiddle/pointwise muls use

    def __init__(self, N: int = 1 << 16, unsigned: bool = True,
                 device="cpu"):
        self.N = N
        self.unsigned = unsigned
        n1 = 1 << ((N.bit_length() - 1) // 2)
        self.N1, self.N2 = n1, N // n1
        N1, N2 = self.N1, self.N2
        q = _Q
        g = find_primitive_root(q)
        psi = pow(g, (q - 1) // (2 * N), q)
        om = pow(psi, 2, q)
        om1 = pow(om, N2, q)          # order N1
        om2 = pow(om, N1, q)          # order N2
        psi_i = pow(psi, q - 2, q)
        om_i = pow(om, q - 2, q)
        om1_i = pow(om1, q - 2, q)
        om2_i = pow(om2, q - 2, q)
        n_inv = pow(N, q - 2, q)

        i1 = np.arange(N1)
        i2 = np.arange(N2)
        e1 = np.outer(i1, i1) % N1     # exponents of the order-N1 roots
        e2 = np.outer(i2, i2) % N2
        # W1'[k1, n1] = om1^(k1 n1) * psi^(n1 N2)   (twist absorbed)
        W1 = _pow_table(om1, N1)[e1] * _pow_table(pow(psi, N2, q), N1) % q
        # W2[k2, n2] = om2^(k2 n2)
        W2 = _pow_table(om2, N2)[e2]
        # inverse: W2i[n2, k2] = om2^(-k2 n2)
        W2i = _pow_table(om2_i, N2)[e2]
        # W1i[n1, k1] = om1^(-k1 n1) * psi^(-n1 N2) / N
        W1i = (_pow_table(om1_i, N1)[e1]
               * _pow_table(pow(psi_i, N2, q), N1)[:, None] % q
               * n_inv % q)
        self.mat1 = PrescaledMat(W1, unsigned)
        self.mat2 = PrescaledMat(W2, unsigned)
        self.mat2i = PrescaledMat(W2i, unsigned)
        self.mat1i = PrescaledMat(W1i, unsigned)

        # mid twiddle T[k1, n2] = psi^(n2) * om^(k1 n2); twi in [n2, k1]
        ek = np.outer(i1, i2)          # k1 * n2 < N
        self.tw = (_pow_table(psi, N2)[None, :]
                   * _pow_table(om, N)[ek] % q).astype(np.uint64)
        self.twi = (_pow_table(psi_i, N2)[:, None]
                    * _pow_table(om_i, N)[ek.T] % q).astype(np.uint64)

        self.device = get_device(device)
        self.c = from_jax_consts(self.consts(), self.device)

    # -- layout helpers ---------------------------------------------------
    def _to_internal(self, x):
        """[B, N] -> [n1, B, n2] (a strided view)."""
        B = x.shape[0]
        return x.reshape(B, self.N1, self.N2).permute(1, 0, 2)

    def _from_internal(self, x):
        """[n1, B, n2] -> [B, N] (contiguous)."""
        return x.permute(1, 0, 2).reshape(-1, self.N)

    # -- epilogues (overridden by the fused subclass) ----------------------
    def _fold_end(self, mat, V, B, t):
        """int32 buckets [K*R, B*t] -> u64 [R, B, t]."""
        return mat.fold(V).reshape(mat.R, B, t)

    def _fold_tw(self, mat, V, tw, B, t):
        """fold + mid-twiddle (tw: storage [R, t], broadcast over B)."""
        y = mat.fold(V).reshape(mat.R, B, t)
        return self.F.mul(y, tw[:, None, :])

    def _dot(self, mat, x, c, key):
        C, B, t = x.shape
        return mat.dot(x.reshape(C, B * t), c[key], c.get(key + "_corr"))

    def _lvl_end(self, mat, x, c, key):
        C, B, t = x.shape
        return self._fold_end(mat, self._dot(mat, x, c, key), B, t)

    def _lvl_tw(self, mat, x, c, key, tw_key):
        C, B, t = x.shape
        return self._fold_tw(mat, self._dot(mat, x, c, key), c[tw_key],
                             B, t)

    def _lvl_tw_t(self, mat, x, c, key, tw_key):
        """_lvl_tw followed by the mid transpose [R, B, t] -> [t, B, R]."""
        return self._lvl_tw(mat, x, c, key, tw_key).permute(2, 1, 0)

    # -- tables -------------------------------------------------------------
    def consts(self) -> dict[str, np.ndarray]:
        """The host tables, byte-equal to the reference's ``consts()``."""
        return {"w1": self.mat1.big, "w2": self.mat2.big,
                "w2i": self.mat2i.big, "w1i": self.mat1i.big,
                "tw": self.tw, "twi": self.twi}

    def _c(self, c):
        return self.c if c is None else c

    # -- transforms --------------------------------------------------------
    def forward_internal(self, x, c=None):
        """[n1, B, n2] coeffs -> [k2, B, k1] evaluations."""
        c = self._c(c)
        a = self._lvl_tw_t(self.mat1, x, c, "w1", "tw")     # [n2, B, k1]
        return self._lvl_end(self.mat2, a, c, "w2")

    def inverse_internal(self, y, c=None):
        """[k2, B, k1] -> [n1, B, n2] coefficients."""
        c = self._c(c)
        a = self._lvl_tw_t(self.mat2i, y, c, "w2i", "twi")  # [k1, B, n2]
        return self._lvl_end(self.mat1i, a, c, "w1i")

    def mul(self, a, b, c=None):
        """Full negacyclic ring multiply [B, N] x [B, N] -> [B, N]."""
        fa = self.forward_internal(self._to_internal(a), c)
        fb = self.forward_internal(self._to_internal(b), c)
        return self._from_internal(
            self.inverse_internal(self.pointwise(fa, fb), c))

    def pointwise(self, fa, fb):
        return self.F.mul(fa, fb)

    # -- fixed-operand (cached-transform) multiply --------------------------
    def precompute(self, b, c=None):
        """Opaque cached-operand state for :meth:`mul_cached`
        (evaluations here; level-2 buckets in the fused subclass)."""
        return self.forward_internal(self._to_internal(b), c)

    def mul_cached(self, a, fb, c=None):
        """[B, N] x precompute(b) -> a*b mod (q, X^N+1).

        fb may come from a batch-1 b: the internal layout [k2, 1, k1]
        broadcasts over the batch axis."""
        fa = self.forward_internal(self._to_internal(a), c)
        return self._from_internal(
            self.inverse_internal(self.pointwise(fa, fb), c))

    def square(self, a, c=None):
        """a*a with ONE forward transform."""
        fa = self.forward_internal(self._to_internal(a), c)
        return self._from_internal(
            self.inverse_internal(self.pointwise(fa, fa), c))
