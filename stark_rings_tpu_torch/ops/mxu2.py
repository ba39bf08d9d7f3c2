"""Power-of-two negacyclic ring multiply as two modular matmul levels
with pre-scaled 8-bit digit weights (counterpart of
``stark_rings_tpu/ops/mxu2.py``); deg 2^16 Goldilocks (256x256) is the
main path.

:class:`Mxu2NTT` here is the plain, kernel-free whole multiply: the
digit GEMMs go to ``torch._int_mm`` and every fold, twiddle and slot
product is plain tensor code.  ``ops/fold.py`` subclasses it with the
fold epilogues in hand-written CUDA kernels, and ``ops/mxu_bb.py``
sets its field to BabyBear.

Layouts (B = batch), as in the reference:
  coeff domain   [B, N],  N = N1*N2, n = n1*N2 + n2
  internal       [n1, B, n2]  (contraction axis leading)
  NTT domain     [k2, B, k1]  — a fixed frequency order shared by the
  slot product and the inverse, so ring multiplication is exact.

The reference's compiled calls (``jit_mul``, ``jit_mul_cached``,
``jit_square``, ``staged_mul``) are CUDA graph replays on the card
(``ops/graphed.py``) and the methods themselves on the CPU.

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
import torch.nn.functional as TF

from ..device import get_device, to_numpy_u64, to_torch, to_torch_u32
from ..fields.field import GOLDILOCKS, MASK32, shr
from ..utils.trace import trace_span
from .graphed import GraphSet, graphed
from .ntt import find_primitive_root

__all__ = ["Mxu2NTT", "PrescaledMat", "from_jax_consts", "digit_table",
           "BIAS_MOD_Q"]

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


def _pow_table(base: int, n: int, q: int) -> np.ndarray:
    """[base^0, ..., base^(n-1)] mod q as an object array of ints."""
    out = np.empty(n, dtype=object)
    v = 1
    for i in range(n):
        out[i] = v
        v = v * base % q
    return out


def _round8(n):
    return -(-n // 8) * 8


def _mm(a, b):
    """Exact int8 [m, k] @ int8 [k, n] -> int32 [m, n] through
    ``torch._int_mm``, zero-padded to at least 24 rows and to multiples of
    8, with b column-major (the layout it takes on every backend)."""
    m, kd = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(24, _round8(m)), _round8(kd), _round8(n)
    a = TF.pad(a, (0, kp - kd, 0, mp - m)).contiguous()
    bt = TF.pad(b.t(), (0, kp - kd, 0, np_ - n)).contiguous()
    return torch._int_mm(a, bt.t())[:m, :n]


def _mulmod(m: np.ndarray, c: int, q: int) -> np.ndarray:
    """(m * c) mod q for a uint64 array m of values below q: numpy words
    for q < 2^32, the Goldilocks field's product for its q, python ints
    for any other 64-bit q (frog's small model matrices)."""
    if q < 1 << 32:
        return m * np.uint64(c) % np.uint64(q)
    if q != _Q:
        return (m.astype(object) * c % q).astype(np.uint64)
    return to_numpy_u64(_f.mul(to_torch(m, "cpu"), _f.const(c, "cpu")))


class PrescaledMat:
    """Constant [R, C] matrix over the field ``F`` with pre-scaled 8-bit
    digit planes.

    ``big`` is a numpy array, byte-equal to the reference's: uint8
    [K*R, P*C] for the unsigned scheme (P data bytes of a storage word
    times K weight bytes), int8 for the signed one (P 7-bit data digits
    times K signed weight digits).  Plane ``l``'s weights are
    ``M * 2^(d_bits*l) * SCALE mod q``; ``SCALE`` is 1 here and the
    Montgomery factor 2^32 in the BabyBear subclass (``ops/mxu_bb.py``).
    """

    F = _f
    SCALE = 1
    K_U8, P_U8 = K_BUCKETS_U8, P_PLANES_U8
    K_S, P_S, D_S = K_BUCKETS, P_PLANES, D_BITS

    def __init__(self, m_ints, unsigned: bool = True):
        q = self.F.q
        m = (np.asarray(m_ints, dtype=object) % q).astype(np.uint64)
        R, C = m.shape
        self.R, self.C = R, C
        self.unsigned = unsigned
        self.K = self.K_U8 if unsigned else self.K_S
        self.P = self.P_U8 if unsigned else self.P_S
        self.d_bits = D_BITS_U8 if unsigned else self.D_S
        K, P = self.K, self.P
        if unsigned:
            # int32 accumulation bound: P*C products of <= 255*255
            assert P * C * 255 * 255 < 2**31
            big = np.zeros((K * R, P * C), dtype=np.uint8)
        else:
            # int32 accumulation bound: P*C products of |.| <= 128*127
            assert P * C * 128 * 127 < 2**31
            big = np.zeros((K * R, P * C), dtype=np.int8)
        for l in range(P):
            scale = pow(2, self.d_bits * l, q) * self.SCALE % q
            v = _mulmod(m, scale, q)
            cols = slice(l * C, (l + 1) * C)
            if unsigned:
                for k in range(K):
                    big[k * R:(k + 1) * R, cols] = (
                        (v >> np.uint64(8 * k))
                        & np.uint64(0xFF)).astype(np.uint8)
                continue
            carry = np.zeros((R, C), dtype=np.int16)
            for k in range(K - 1):
                byte = ((v >> np.uint64(8 * k))
                        & np.uint64(0xFF)).astype(np.int16) + carry
                carry = (byte >= 128).astype(np.int16)
                big[k * R:(k + 1) * R, cols] = (byte - 256 * carry).astype(
                    np.int8)
            # v < 2^(8(K-1)) so the top digit is exactly the final carry
            big[(K - 1) * R:, cols] = carry.astype(np.int8)
        self.big = big

    # -- data digits ----------------------------------------------------------
    def _planes(self, x: torch.Tensor, xor: int = 0) -> torch.Tensor:
        """Storage words [C, cols] (int64 Goldilocks, int32 BabyBear) ->
        digit planes [P*C, cols], column-major (stride (1, P*C)): the
        layout ``_int_mm`` takes on every backend for its second operand.
        Plane ``l`` holds bits [d_bits*l, d_bits*(l+1)) of each value.

        Unsigned scheme: the 8-bit digits are the little-endian bytes of
        the words (P of them per word), each XORed with ``xor``: one
        transpose, then one byte gather within each row of C words."""
        C, cols = x.shape
        if self.unsigned:
            buf = torch.empty((cols, self.P, C), dtype=torch.uint8,
                              device=x.device)
            by = x.t().contiguous().view(torch.uint8).view(cols, C, self.P)
            torch.bitwise_xor(by.permute(0, 2, 1), xor, out=buf)
        else:
            buf = torch.empty((cols, self.P, C), dtype=torch.int8,
                              device=x.device)
            xt = x.t()
            # int32 storage is below 2^31: its arithmetic shift is logical
            right = (shr if x.dtype == torch.int64
                     else torch.bitwise_right_shift)
            for l in range(self.P):
                sh = self.d_bits * l
                buf[:, l, :] = (right(xt, sh) if sh else xt) & 0x7F
        return buf.view(cols, self.P * C).t()

    def planes(self, x: torch.Tensor) -> torch.Tensor:
        """Storage [C, cols] -> uint8/int8 [P*C, cols] of 8/7-bit digits
        (the reference's ``planes``; column-major)."""
        return self._planes(x)

    def dot(self, x: torch.Tensor, w: torch.Tensor,
            w_corr: torch.Tensor | None = None) -> torch.Tensor:
        """Storage [C, cols] -> int32 bucket planes [K*R, cols].

        ``w`` and ``w_corr`` are this matrix's device table and, for the
        unsigned scheme, its offset correction (see
        :func:`from_jax_consts`)."""
        with trace_span("digits.planes"):
            s = (self._planes(x, 0x80).view(torch.int8)  # d ^ 0x80 = d - 128
                 if self.unsigned else self._planes(x))
        V = torch._int_mm(w, s)
        if not self.unsigned:
            return V
        with trace_span("digits.offsets"):
            KR = self.K * self.R
            V, colsum = V[:KR], V[KR]   # row K*R: the ones row, sum_c s[c, j]
            V += w_corr
            V += 128 * colsum
        return V

    def apply(self, x: torch.Tensor, w: torch.Tensor,
              w_corr: torch.Tensor | None = None) -> torch.Tensor:
        """M @ x mod q for storage x [C, cols] -> [R, cols] (the
        reference's ``apply``), with this matrix's device table ``w`` and
        offset correction ``w_corr`` (:func:`digit_table`).  The columns
        are zero-padded to a multiple of 8 for ``_int_mm`` and dropped
        after the fold."""
        cols = x.shape[1]
        pad = _round8(cols) - cols
        y = self.fold(self.dot(TF.pad(x, (0, pad)) if pad else x, w, w_corr))
        return y[:, :cols] if pad else y

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


def digit_table(big, device, what: str = "digit table"):
    """One matrix's ``big`` digit planes (uint8 or int8 numpy) -> its
    device table for :meth:`PrescaledMat.dot` and, for the unsigned
    scheme, the offset correction (else None); see
    :func:`from_jax_consts`."""
    big = np.asarray(big)
    dev = get_device(device)
    if big.dtype == np.uint8:
        ws = (big ^ np.uint8(0x80)).view(np.int8)
        corr = (128 * ws.sum(axis=1, dtype=np.int64)
                + 128 * 128 * big.shape[1]).astype(np.int32)
        extra = np.zeros((8, big.shape[1]), dtype=np.int8)
        extra[0] = 1
        return (torch.from_numpy(np.concatenate([ws, extra])).to(dev),
                torch.from_numpy(corr[:, None]).to(dev))
    if big.dtype == np.int8:
        return torch.from_numpy(big.copy()).to(dev), None
    raise TypeError(f"{what}: expected a uint8 or int8 digit table, got "
                    f"{big.dtype}")


def from_jax_consts(consts: dict, device) -> dict[str, torch.Tensor]:
    """The reference's (or the port's own) numpy tables -> the port's
    device tables, key by key:

    * a uint8 or int8 digit table (``w1``/``w2``/``w2i``/``w1i`` of the
      engines, ``crt``/``icrt`` of the ring models): int8 [K*R, P*C], the
      form ``_int_mm`` takes.  A uint8 (unsigned-scheme) table is stored
      as ``W ^ 0x80`` viewed as int8 (``W - 128``), followed by a row of
      ones and 7 rows of zeros ([K*R + 8, P*C]), so that the GEMM also
      returns the data digits' column sums.  It gets a second entry
      ``<key>_corr``: int32 [K*R, 1] = 128 sum_c (W - 128)[r, c]
      + 128^2 (P*C), the row-constant part of the offset identity.
    * a uint64 or uint32 table (the twiddles ``tw``/``twi``): the field's
      storage, int64 tensors of u64 bits (Goldilocks) or int32 tensors of
      u32 Montgomery words (BabyBear).
    """
    dev = get_device(device)
    out = {}
    for key, tab in consts.items():
        tab = np.asarray(tab)
        if tab.dtype in (np.uint8, np.int8):
            w, corr = digit_table(tab, dev, key)
            out[key] = w
            if corr is not None:
                out[key + "_corr"] = corr
        elif tab.dtype == np.uint64:
            out[key] = to_torch(tab, dev)
        elif tab.dtype == np.uint32:
            out[key] = to_torch_u32(tab, dev)
        else:
            raise TypeError(f"{key}: expected a uint8/int8 digit table or "
                            f"a uint64/uint32 storage table, got "
                            f"{tab.dtype}")
    return out


class Mxu2NTT:
    """Negacyclic ring multiply for N = N1*N2 (default 256*256 = 2^16;
    ``n1`` defaults to 2^floor(log2(N)/2)).

    The tables are built on the host with numpy, byte-equal to the
    reference's :meth:`consts`, and moved to ``device`` once, here.
    ``F`` (the field of the twiddle and slot products) and ``MAT`` (its
    digit-plane matrix) are the only field-specific parts:
    ``ops/mxu_bb.py`` sets them for BabyBear."""

    F = _f
    MAT = PrescaledMat

    def __init__(self, N: int = 1 << 16, n1: int | None = None,
                 unsigned: bool = True, device="cuda"):
        self.device = get_device(device)
        q = self.F.q
        if N < 4 or N & (N - 1) or (q - 1) % (2 * N):
            raise ValueError(f"N={N}: need a power of two >= 4 with 2N "
                             f"dividing q-1 ({self.F.name})")
        self.N = N
        self.unsigned = unsigned
        if n1 is None:
            n1 = 1 << ((N.bit_length() - 1) // 2)
        self.N1, self.N2 = n1, N // n1
        N1, N2 = self.N1, self.N2
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
        W1 = (_pow_table(om1, N1, q)[e1]
              * _pow_table(pow(psi, N2, q), N1, q) % q)
        # W2[k2, n2] = om2^(k2 n2)
        W2 = _pow_table(om2, N2, q)[e2]
        # inverse: W2i[n2, k2] = om2^(-k2 n2)
        W2i = _pow_table(om2_i, N2, q)[e2]
        # W1i[n1, k1] = om1^(-k1 n1) * psi^(-n1 N2) / N
        W1i = (_pow_table(om1_i, N1, q)[e1]
               * _pow_table(pow(psi_i, N2, q), N1, q)[:, None] % q
               * n_inv % q)
        self.mat1 = self.MAT(W1, unsigned)
        self.mat2 = self.MAT(W2, unsigned)
        self.mat2i = self.MAT(W2i, unsigned)
        self.mat1i = self.MAT(W1i, unsigned)

        # mid twiddle T[k1, n2] = psi^(n2) * om^(k1 n2); twi in [n2, k1];
        # in storage form (Montgomery for BabyBear), as the slot products
        # that use them take it
        ek = np.outer(i1, i2)          # k1 * n2 < N
        self.tw = self.F.storage_np(_pow_table(psi, N2, q)[None, :]
                                    * _pow_table(om, N, q)[ek] % q)
        self.twi = self.F.storage_np(_pow_table(psi_i, N2, q)[:, None]
                                     * _pow_table(om_i, N, q)[ek.T] % q)
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

    def forward(self, x, c=None):
        """[B, N] coefficients -> [B, N] evaluations, the reference's
        ``forward``: the [k2, B, k1] evaluations read as [B, k1, k2]."""
        return self._from_internal(
            self.forward_internal(self._to_internal(x), c).permute(2, 1, 0))

    def mul(self, a, b, c=None):
        """Full negacyclic ring multiply [B, N] x [B, N] -> [B, N]."""
        with trace_span("mxu.mul"):
            with trace_span("mxu.forward"):
                fa = self.forward_internal(self._to_internal(a), c)
            with trace_span("mxu.forward"):
                fb = self.forward_internal(self._to_internal(b), c)
            with trace_span("mxu.pointwise"):
                prod = self.pointwise(fa, fb)
            with trace_span("mxu.inverse"):
                out = self.inverse_internal(prod, c)
            return self._from_internal(out)

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

    # -- compiled calls -------------------------------------------------------
    # The reference's jax.jit entry points.  The tables already lie on the
    # device (``self.c``); on CUDA inputs each call below is one CUDA
    # graph replay (``ops/graphed.py``), on CPU inputs the method itself.

    def jit_mul(self):
        """:meth:`mul` as one replay a call."""
        return graphed(self.mul)

    def jit_mul_cached(self):
        """:meth:`mul_cached` as one replay a call, with
        ``.precompute`` (:meth:`precompute`, one replay) beside it; both
        capture into one memory pool.  A batch-1 state broadcasts."""
        graphs = GraphSet()
        mul = graphs.wrap(self.mul_cached)
        mul.precompute = graphs.wrap(self.precompute)
        return mul

    def jit_square(self):
        """:meth:`square` as one replay a call."""
        return graphed(self.square)

    def staged_mul(self, granularity: str = "stage"):
        """The multiply composed in Python from separately compiled
        pieces (the reference's ``staged_mul``): the same function at
        another number of replays a call, ``.forward`` ([B, N] ->
        [k2, B, k1] evaluations) beside it.

        granularity:
          "stage"     — 8 graphs, 13 replays a multiply: to internal
                        layout, level 1, the mid transpose, level 2 (each
                        forward twice), the slot product, inverse level 2,
                        the transpose, inverse level 1, from internal;
          "mixed"     — 5 replays: the forward transform (twice), the
                        slot product, the inverse in two halves;
          "mixed4"    — 4 replays: as "mixed", the slot product in the
                        first inverse half;
          "transform" — 3 replays: the forward transform (twice) and
                        the slot product with the whole inverse.
        """
        g = GraphSet().wrap
        c = self.c
        if granularity == "stage":
            ti = g(lambda x: self._to_internal(x).contiguous())
            l1 = g(lambda x: self._lvl_tw(self.mat1, x, c, "w1", "tw"))
            tr = g(lambda a: a.permute(2, 1, 0).contiguous())
            l2 = g(lambda a: self._lvl_end(self.mat2, a, c, "w2"))
            pw = g(self.pointwise)
            l2i = g(lambda y: self._lvl_tw(self.mat2i, y, c, "w2i", "twi"))
            l1i = g(lambda a: self._lvl_end(self.mat1i, a, c, "w1i"))
            fi = g(self._from_internal)

            def fwd(x):
                return l2(tr(l1(ti(x))))

            def mul(a, b):
                return fi(l1i(tr(l2i(pw(fwd(a), fwd(b))))))
        elif granularity == "transform":
            fwd = g(self._fwd_graph)
            tail = g(self._tail_graph)

            def mul(a, b):
                return tail(fwd(a), fwd(b))
        elif granularity in ("mixed", "mixed4"):
            fwd = g(self._fwd_graph)
            inv2 = g(lambda a: self._from_internal(
                self._lvl_end(self.mat1i, a, c, "w1i")))
            if granularity == "mixed4":
                inv1 = g(lambda fa, fb: self._lvl_tw_t(
                    self.mat2i, self.pointwise(fa, fb), c, "w2i", "twi"))

                def mul(a, b):
                    return inv2(inv1(fwd(a), fwd(b)))
            else:
                pw = g(self.pointwise)
                inv1 = g(lambda y: self._lvl_tw_t(self.mat2i, y, c, "w2i",
                                                  "twi"))

                def mul(a, b):
                    return inv2(inv1(pw(fwd(a), fwd(b))))
        else:
            raise ValueError(f"staged_mul: granularity {granularity!r} is "
                             "not one of 'stage', 'mixed', 'mixed4', "
                             "'transform'")
        mul.forward = fwd
        return mul

    def _fwd_graph(self, x):
        return self.forward_internal(self._to_internal(x))

    def _tail_graph(self, fa, fb):
        return self._from_internal(
            self.inverse_internal(self.pointwise(fa, fb)))
