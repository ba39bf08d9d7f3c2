"""Digit-plane matmul and the four-step ring multiply for the 8-limb
stark prime (counterpart of ``stark_rings_tpu/ops/mxu_limb.py``).

:class:`LimbPrescaledMat` applies a constant [R, C] matrix over the
252-bit field as one int8 GEMM and one bucket fold, the construction of
``ops/mxu2.py`` sized for an 8-limb modulus:

* unsigned scheme (the default): 32 u8 data planes, the bytes of the u32
  storage limbs (no digit straddles a limb), times 32 u8 weight digits;
  the weights are ``M * 2^(8l) * 2^256 mod q``, digitized little-endian;
* signed scheme (``unsigned=False``): 36 7-bit data planes times 33
  signed 8-bit weight digits, each bucket biased by 2^26 in the fold;
* the fold (kernel S3, :func:`~.stark.limb_fold`): the K buckets packed
  into base-2^32 words, eight word-REDC rounds (the weights' 2^256
  cancels) and one conditional subtract.

``big`` is byte-equal to the reference's in both schemes.  The u8 x u8
product goes through ``torch._int_mm`` with the offset identity of
``PrescaledMat.dot`` (``_int_mm`` takes int8 only).

:class:`MxuLimbNTT` is the reference's four-step negacyclic multiply on
these matrices: four level GEMMs (each a ``_int_mm`` and an S3 fold) and
the rank-1 mid twiddle and the slot product as Montgomery products
(kernel S1, broadcast over the batch).  It keeps the reference's
internal layout [B, n2, n1, L] and evaluation layout [B, k1, k2, L].
Montgomery storage commutes with Fq-linear maps, so the matrices apply
to storage limbs directly.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from ..device import get_device
from ..fields import STARK
from .graphed import graphed
from .mxu2 import PrescaledMat, _round8, from_jax_consts
from .ntt import find_primitive_root
from .stark import limb_fold

__all__ = ["LimbPrescaledMat", "MxuLimbNTT"]

D_BITS = 7      # signed scheme: 7-bit data digits
B_BITS = 8      # weight digits (bucket shift)


class LimbPrescaledMat(PrescaledMat):
    """Constant [R, C] matrix over the stark prime with pre-scaled
    digit planes.  ``big`` (numpy) is uint8 [32R, 32C] unsigned or int8
    [33R, 36C] signed; the device tables come from
    :func:`~.mxu2.digit_table`, as for the single-word fields."""

    F = STARK

    def __init__(self, m_ints, unsigned: bool = True):
        q = STARK.q
        qbits = q.bit_length()
        m = np.asarray(m_ints, dtype=object)
        R, C = m.shape
        self.R, self.C = R, C
        self.unsigned = unsigned
        self.L = STARK.N_LIMBS
        if unsigned:
            self.d_bits = 8
            self.P = -(-qbits // 8)
            self.K = -(-qbits // B_BITS)
            assert self.P * C * 255 * 255 < 2**31, \
                "int32 accumulation overflow"
        else:
            self.d_bits = D_BITS
            self.P = -(-qbits // D_BITS)
            self.K = (qbits + B_BITS - 1) // B_BITS + 1
            assert self.P * C * 128 * 127 < 2**31, \
                "int32 accumulation overflow"
        P, K = self.P, self.K
        rmont = pow(2, 32 * self.L, q)     # the fold divides by 2^256
        scales = [pow(2, self.d_bits * l, q) * rmont % q for l in range(P)]
        flat = [int(v) % q for v in m.reshape(-1)]
        data = b"".join((v * s % q).to_bytes(32, "little")
                        for s in scales for v in flat)
        byt = np.frombuffer(data, dtype=np.uint8).reshape(P, R, C, 32)
        if unsigned:
            dig = byt                       # [l, r, c, k], K = 32
        else:
            dig = np.empty((P, R, C, K), dtype=np.int8)
            carry = np.zeros((P, R, C), dtype=np.int16)
            for k in range(K - 1):
                b = byt[..., k].astype(np.int16) + carry
                carry = (b >= 128).astype(np.int16)
                dig[..., k] = (b - 256 * carry).astype(np.int8)
            dig[..., K - 1] = carry         # v < 2^256: the final carry
        # big[k*R + r, l*C + c] = digit k of M[r, c] * scale_l
        self.big = np.ascontiguousarray(
            dig.transpose(3, 1, 0, 2)).reshape(K * R, P * C)

    # -- data digits ----------------------------------------------------------
    def _planes(self, x: torch.Tensor, xor: int = 0) -> torch.Tensor:
        """Storage limbs [C, cols, 8] (any strides; the batch-leading
        [cols, C, 8] passes as its transposed view) -> digit planes
        [P*C, cols], column-major, row l*C + c holding bits
        [d_bits*l, d_bits*(l+1)) of x[c, :].

        Unsigned: the planes are the 32 little-endian bytes of the limbs,
        each XORed with ``xor``: one byte transpose.  Signed: 7-bit
        windows, straddling two limbs where they cross a limb edge."""
        C, cols = x.shape[0], x.shape[1]
        xl = x.transpose(0, 1).contiguous()          # [cols, C, 8]
        if self.unsigned:
            buf = torch.empty((cols, self.P, C), dtype=torch.uint8,
                              device=x.device)
            by = xl.view(torch.uint8).view(cols, C, self.P)
            torch.bitwise_xor(by.permute(0, 2, 1), xor, out=buf)
        else:
            buf = torch.empty((cols, self.P, C), dtype=torch.int8,
                              device=x.device)
            x64 = xl.to(torch.int64) & 0xFFFFFFFF
            for l in range(self.P):
                pos = self.d_bits * l
                j, off = pos >> 5, pos & 31
                lo = x64[..., j] >> off
                if off > 32 - self.d_bits and j + 1 < self.L:
                    lo = lo | (x64[..., j + 1] << (32 - off))
                buf[:, l, :] = lo & 0x7F
        return buf.view(cols, self.P * C).t()

    def fold(self, V: torch.Tensor, transpose_out: bool = False):
        """int32 [K*R, cols] buckets -> canonical limbs [R, cols, 8] (or
        [cols, R, 8]): kernel S3 on the card."""
        return limb_fold(V, self.R, signed=not self.unsigned,
                         transpose_out=transpose_out)

    def apply(self, x: torch.Tensor, w: torch.Tensor,
              w_corr: torch.Tensor | None,
              transpose_out: bool = False) -> torch.Tensor:
        """M @ x mod q for x [C, cols, 8] (the batch-trailing layout, or
        the transposed view of a batch-leading [cols, C, 8]) -> [R, cols,
        8], or [cols, R, 8] with ``transpose_out``.  The columns are
        zero-padded to a multiple of 8 for ``_int_mm`` and dropped after
        the fold."""
        cols = x.shape[1]
        pad = _round8(cols) - cols
        if pad:
            x = TF.pad(x, (0, 0, 0, pad))
        y = self.fold(self.dot(x, w, w_corr), transpose_out)
        if not pad:
            return y
        return y[:cols] if transpose_out else y[:, :cols]

    def __call__(self, x: torch.Tensor, w: torch.Tensor,
                 w_corr: torch.Tensor | None = None) -> torch.Tensor:
        """Storage [..., C, 8] -> M @ x mod q, [..., R, 8] (the
        reference's ``__call__``), with this matrix's device tables
        ``w`` / ``w_corr`` from :func:`~.mxu2.digit_table`."""
        lead = x.shape[:-2]
        y = self.apply(x.reshape(-1, self.C, 8).transpose(0, 1), w, w_corr,
                       transpose_out=True)
        return y.reshape(lead + (self.R, 8))


class MxuLimbNTT:
    """Four-step negacyclic ring multiply over the stark prime (2-adicity
    192: any power-of-two N = N1*N2), coefficients in and out in storage
    form, bit-equal to :class:`~.ntt.NTTContext`.  Operands are
    [B, N, 8]; the tables are built on the host, byte-equal to the
    reference's :meth:`consts`, and moved to ``device`` once."""

    F = STARK

    def __init__(self, N: int, n1: int | None = None, unsigned: bool = True,
                 device="cuda"):
        f = self.F
        q = f.q
        if N < 4 or N & (N - 1) or (q - 1) % (2 * N):
            raise ValueError(f"N={N}: need a power of two >= 4 with 2N "
                             "dividing q-1")
        self.device = get_device(device)
        self.N = N
        if n1 is None:
            n1 = 1 << ((N.bit_length() - 1) // 2)
        self.N1, self.N2 = n1, N // n1
        N1, N2 = self.N1, self.N2
        g = find_primitive_root(q)
        psi = pow(g, (q - 1) // (2 * N), q)
        om = pow(psi, 2, q)
        om1, om2 = pow(om, N2, q), pow(om, N1, q)
        psi_i, om_i = pow(psi, q - 2, q), pow(om, q - 2, q)
        om1_i, om2_i = pow(om1, q - 2, q), pow(om2, q - 2, q)
        n_inv = pow(N, q - 2, q)

        def powers(base, n):
            out, v = [], 1
            for _ in range(n):
                out.append(v)
                v = v * base % q
            return out

        p1, p2 = powers(om1, N1), powers(om2, N2)
        p1i, p2i = powers(om1_i, N1), powers(om2_i, N2)
        ps, psi_ = powers(pow(psi, N2, q), N1), powers(pow(psi_i, N2, q), N1)
        W1 = [[p1[k1 * j % N1] * ps[j] % q for j in range(N1)]
              for k1 in range(N1)]
        W2 = [[p2[k2 * j % N2] for j in range(N2)] for k2 in range(N2)]
        W2i = [[p2i[j * k2 % N2] for k2 in range(N2)] for j in range(N2)]
        W1i = [[p1i[j * k1 % N1] * psi_[j] % q * n_inv % q
                for k1 in range(N1)] for j in range(N1)]
        self.mat1 = LimbPrescaledMat(W1, unsigned)
        self.mat2 = LimbPrescaledMat(W2, unsigned)
        self.mat2i = LimbPrescaledMat(W2i, unsigned)
        self.mat1i = LimbPrescaledMat(W1i, unsigned)

        pom, pomi = powers(om, N), powers(om_i, N)
        pps, ppsi = powers(psi, N2), powers(psi_i, N2)
        tw = np.empty((N2, N1), dtype=object)     # [n2, k1]
        twi = np.empty((N1, N2), dtype=object)    # [k1, n2]
        for k1 in range(N1):
            for j in range(N2):
                tw[j, k1] = pps[j] * pom[k1 * j % N] % q
                twi[k1, j] = ppsi[j] * pomi[k1 * j % N] % q
        self.tw = f.storage_np(tw)        # numpy storage [n2, k1, 8]
        self.twi = f.storage_np(twi)      # numpy storage [k1, n2, 8]
        self.c = from_jax_consts(self.consts(), self.device)

    def consts(self) -> dict:
        """The digit tables and twiddles as numpy arrays, byte-equal to
        the reference's ``consts()``; ``from_jax_consts`` of either
        package's gives the device tables ``c``."""
        return {"w1": self.mat1.big, "w2": self.mat2.big,
                "w2i": self.mat2i.big, "w1i": self.mat1i.big,
                "tw": self.tw, "twi": self.twi}

    # -- layout: internal [B, n2, n1, L] / evaluations [B, k1, k2, L] -------
    def _to_internal(self, x):
        return x.reshape(x.shape[0], self.N1, self.N2, 8).transpose(1, 2)

    def _from_internal(self, v):
        return v.transpose(1, 2).reshape(v.shape[0], self.N, 8)

    def forward_internal(self, v, c=None):
        """[B, n2, n1, L] coefficients -> [B, k1, k2, L] evaluations."""
        c = self.c if c is None else c
        a = self.mat1(v, c["w1"], c.get("w1_corr"))   # [B, n2, k1, L]
        a = self.F.mul(a, c["tw"])                      # mid twiddle
        return self.mat2(a.transpose(1, 2), c["w2"], c.get("w2_corr"))

    def inverse_internal(self, y, c=None):
        """[B, k1, k2, L] evaluations -> [B, n2, n1, L] coefficients."""
        c = self.c if c is None else c
        a = self.mat2i(y, c["w2i"], c.get("w2i_corr"))   # [B, k1, n2, L]
        a = self.F.mul(a, c["twi"])
        return self.mat1i(a.transpose(1, 2), c["w1i"], c.get("w1i_corr"))

    def forward(self, x, c=None):
        return self.forward_internal(self._to_internal(x), c)

    def inverse(self, y, c=None):
        return self._from_internal(self.inverse_internal(y, c))

    def mul(self, a, b, c=None):
        """[B, N, 8] x [B, N, 8] -> [B, N, 8] negacyclic product."""
        return self.inverse(self.F.mul(self.forward(a, c),
                                       self.forward(b, c)), c)

    def precompute(self, b, c=None):
        """The cached state of a fixed operand (its evaluations) for
        :meth:`mul_cached`; a batch-1 state broadcasts."""
        return self.forward(b, c)

    def mul_cached(self, a, fb, c=None):
        """Multiply by a precomputed operand: one forward saved."""
        return self.inverse(self.F.mul(self.forward(a, c), fb), c)

    def square(self, a, c=None):
        fa = self.forward(a, c)
        return self.inverse(self.F.mul(fa, fa), c)

    def jit_mul(self):
        """:meth:`mul` compiled: on CUDA inputs one CUDA graph replay a
        call (``ops/graphed.py``), on CPU inputs ``mul`` itself."""
        return graphed(self.mul)
