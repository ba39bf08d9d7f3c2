"""The 252-bit stark prime's limb arithmetic: the 8-limb CIOS Montgomery
product S1, modular add and sub S2, and the ``LimbPrescaledMat`` bucket
fold S3, each a hand-written CUDA kernel with a plain PyTorch twin.

=========  ===============  ===================  ==========================
kernel     wrapper          twin                 reference (XLA code)
=========  ===============  ===================  ==========================
S1         ``stark_mul``    ``stark_mul_ref``    ``_Stark._mont_mul_limbs``
S2         ``stark_add``    ``stark_add_ref``    ``_Stark.add``
S2         ``stark_sub``    ``stark_sub_ref``    ``_Stark.sub``
S3         ``limb_fold``    ``limb_fold_ref``    ``LimbPrescaledMat.fold``
=========  ===============  ===================  ==========================

The reference runs all four in XLA, which fuses each into one pass.  In
eager PyTorch every limb step is a launch (the CIOS loop is some 700 of
them), so on the card each is one kernel of ``csrc/stark.cu``.  None is
the counterpart of a Pallas kernel.

Storage is ``int32 [..., 8]``: the reference's little-endian u32 limbs
of the Montgomery form (R = 2^256), bit for bit.  The twins widen each
limb with ``& 0xFFFFFFFF`` after the int32 -> int64 cast (a plain cast
sign-extends limbs at or above 2^31) and emulate the reference's u64
words on int64: products and sums wrap mod 2^64 as u64 does, and every
``>> 32`` is logical.  The kernels use native u32/u64 words and compute
the same bits on any input, canonical or not.

A wrapper dispatches on its inputs' device: CPU tensors get the twin's
result, CUDA tensors a launch (or an exception; no fallback), and every
launch adds one to ``LAUNCHES[<wrapper name>]``.  S1 and S2 take
operands of broadcastable shapes; the kernels read ``b`` at row
``row mod b_rows``, so a ``b`` whose shape is a suffix of the result's
(a twiddle table [n2, k1, 8] against [B, n2, k1, 8]) is read in place,
and anything else is expanded and made contiguous first.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["stark_mul", "stark_add", "stark_sub", "limb_fold",
           "stark_mul_ref", "stark_add_ref", "stark_sub_ref",
           "limb_fold_ref", "LAUNCHES", "reset_launches", "Q", "Q_LIMBS",
           "QPRIME32", "i32_bits"]

Q = 2**251 + 17 * 2**192 + 1
L = 8                                   # u32 limbs
M32 = 0xFFFFFFFF
Q_LIMBS = [(Q >> (32 * j)) & M32 for j in range(L)]
QPRIME32 = (-pow(Q, -1, 1 << 32)) % (1 << 32)   # -q^-1 mod 2^32
B_BITS = 8                              # bucket shift of the digit GEMM
_BIAS = 1 << 26                         # the signed scheme's bucket bias

LAUNCHES = {"stark_mul": 0, "stark_add": 0, "stark_sub": 0, "limb_fold": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _n_words(K: int) -> int:
    """Base-2^32 words of the fold's accumulator sum_k v_k 2^(8k) over K
    buckets of u32 values (the reference's ``_n_words``)."""
    return (B_BITS * (K - 1) + 31) // 32 + 2


def _bias_red_limbs(K: int) -> list:
    """The signed scheme's bucket bias times 2^-256 mod q, as limbs."""
    bias = sum(_BIAS << (B_BITS * k) for k in range(K))
    v = bias * pow(1 << (32 * L), -1, Q) % Q
    return [(v >> (32 * j)) & M32 for j in range(L)]


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------


def _shr32(x):
    """Logical ``>> 32`` of u64 bit patterns held in int64."""
    return (x >> 32) & M32


def _widen(x: torch.Tensor) -> list:
    """int32 [..., 8] -> eight int64 tensors [...] holding the u32 limbs."""
    x64 = x.to(torch.int64) & M32
    return [x64[..., j] for j in range(L)]


def i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same low 32 bits."""
    return ((x ^ 0x80000000) - 0x80000000).to(torch.int32)


def _pack(limbs) -> torch.Tensor:
    return i32_bits(torch.stack(limbs, dim=-1))


def _geq_q(limbs) -> torch.Tensor:
    """Lexicographic value >= q on limbs below 2^32 (equal counts)."""
    ge = decided = None
    for j in reversed(range(L)):
        gt, lt = limbs[j] > Q_LIMBS[j], limbs[j] < Q_LIMBS[j]
        if ge is None:
            ge, decided = gt, gt | lt
        else:
            ge = ge | (~decided & gt)
            decided = decided | gt | lt
    return ge | ~decided


def _sub_q(limbs, mask) -> list:
    """Subtract q where ``mask``; the borrow wraps as the reference's u64
    subtraction does."""
    out = []
    borrow = torch.zeros_like(limbs[0])
    for j in range(L):
        d = limbs[j] - torch.where(mask, Q_LIMBS[j], 0) - borrow
        borrow = (d < 0).to(torch.int64)
        out.append(d & M32)
    return out


def stark_mul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`stark_mul`: the reference's CIOS loop."""
    A, Bl = _widen(a), _widen(b)
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    zero = torch.zeros(shape, dtype=torch.int64, device=a.device)
    t = [zero] * (L + 2)
    for i in range(L):
        ai = A[i]
        carry = zero
        for j in range(L):
            s = t[j] + ai * Bl[j] + carry
            t[j] = s & M32
            carry = _shr32(s)
        s = t[L] + carry
        t[L] = s & M32
        t[L + 1] = t[L + 1] + _shr32(s)
        m = (t[0] * QPRIME32) & M32
        carry = _shr32(t[0] + m * Q_LIMBS[0])
        for j in range(1, L):
            s = t[j] + m * Q_LIMBS[j] + carry
            t[j - 1] = s & M32
            carry = _shr32(s)
        s = t[L] + carry
        t[L - 1] = s & M32
        t[L] = t[L + 1] + _shr32(s)
        t[L + 1] = zero
    limbs = t[:L]
    return _pack(_sub_q(limbs, (t[L] != 0) | _geq_q(limbs)))


def stark_add_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`stark_add` (the carry out of limb 7 is
    dropped, as the reference drops it: canonical sums stay below
    2^253)."""
    A, Bl = _widen(a), _widen(b)
    limbs = []
    carry = 0
    for j in range(L):
        s = A[j] + Bl[j] + carry
        limbs.append(s & M32)
        carry = s >> 32
    return _pack(_sub_q(limbs, _geq_q(limbs)))


def stark_sub_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`stark_sub`: a - b, plus q if it borrowed."""
    A, Bl = _widen(a), _widen(b)
    limbs = []
    borrow = 0
    for j in range(L):
        d = A[j] - Bl[j] - borrow
        borrow = (d < 0).to(torch.int64)
        limbs.append(d & M32)
    neg = borrow.bool()
    out = []
    carry = 0
    for j in range(L):
        s = limbs[j] + torch.where(neg, Q_LIMBS[j], 0) + carry
        out.append(s & M32)
        carry = s >> 32
    return _pack(out)


def limb_fold_ref(V: torch.Tensor, R: int, *, signed: bool,
                  transpose_out: bool = False) -> torch.Tensor:
    """Plain twin of :func:`limb_fold`: the reference's
    ``LimbPrescaledMat.fold``."""
    K, cols = V.shape[0] // R, V.shape[1]
    zero = torch.zeros((R, cols), dtype=torch.int64, device=V.device)
    words = [zero] * _n_words(K)
    for k in range(K):
        b = V[k * R:(k + 1) * R].to(torch.int64) & M32
        if signed:
            b = (b + _BIAS) & M32
        pos = B_BITS * k
        j, sh = pos >> 5, pos & 31
        contrib = b << sh                       # < 2^56
        words[j] = words[j] + (contrib & M32)
        words[j + 1] = words[j + 1] + (contrib >> 32)
    digits = []
    carry = zero
    for w in words:
        t = w + carry
        digits.append(t & M32)
        carry = t >> 32
    digits += [carry, zero]
    # eight REDC rounds, each an exact division by 2^32
    for _ in range(L):
        m = (digits[0] * QPRIME32) & M32
        carry = zero
        for j in range(L):
            s = digits[j] + m * Q_LIMBS[j] + carry
            digits[j] = s & M32
            carry = _shr32(s)
        for j in range(L, len(digits)):
            s = digits[j] + carry
            digits[j] = s & M32
            carry = _shr32(s)
        digits = digits[1:] + [zero]
    limbs = digits[:L]
    out = _pack(_sub_q(limbs, _geq_q(limbs)))          # [R, cols, 8]
    if signed:
        bias = torch.tensor(_bias_red_limbs(K), dtype=torch.int64)
        out = stark_sub_ref(out, i32_bits(bias).to(V.device))
    return out.transpose(0, 1).contiguous() if transpose_out else out


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check_limbs(name, *xs):
    for x in xs:
        if not isinstance(x, torch.Tensor) or x.dtype != torch.int32 \
                or x.dim() < 1 or x.shape[-1] != L:
            raise TypeError(f"{name}: operands must be int32 [..., {L}] "
                            "limb tensors")


def _operands(a, b, commutative):
    """(a [rows, 8], b [b_rows, 8], result shape) for the kernels:
    a expanded to the result and contiguous; b read in place when its
    shape (leading 1s dropped) ends the result's, else expanded too."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    if commutative and a.shape != shape and b.shape == shape:
        a, b = b, a
    a = a.expand(shape).contiguous()
    bs = tuple(b.shape)
    while len(bs) > 1 and bs[0] == 1:
        bs = bs[1:]
    if bs != tuple(shape[len(shape) - len(bs):]):
        b = b.expand(shape)
    return _aligned(a), _aligned(b.contiguous()), shape


def _aligned(x):
    """x itself when its data is 16-byte aligned (the kernels' vector
    loads), else an aligned copy."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _binary(name, twin, a, b, commutative):
    _check_limbs(name, a, b)
    if not _build.on_cuda(name, a, b):
        return twin(a, b)
    a2, b2, shape = _operands(a, b, commutative)
    out = torch.empty(shape, dtype=torch.int32, device=a2.device)
    rows, b_rows = out.numel() // L, b2.numel() // L
    if rows == 0:
        return out
    if (rows + 255) // 256 >= 2**31:
        raise ValueError(f"{name}: {rows} elements exceed the grid")
    lib = _build.kernels()
    _build.launch(LAUNCHES, name, getattr(lib, "srt_" + name), a2.device,
                  a2.data_ptr(), b2.data_ptr(), b_rows, out.data_ptr(), rows)
    return out


def stark_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """S1: the Montgomery product a * b * 2^-256 mod q of limb tensors of
    broadcastable shapes."""
    return _binary("stark_mul", stark_mul_ref, a, b, True)


def stark_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """S2: a + b mod q on limb tensors of broadcastable shapes."""
    return _binary("stark_add", stark_add_ref, a, b, True)


def stark_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """S2: a - b mod q on limb tensors of broadcastable shapes."""
    return _binary("stark_sub", stark_sub_ref, a, b, False)


def limb_fold(V: torch.Tensor, R: int, *, signed: bool,
              transpose_out: bool = False) -> torch.Tensor:
    """S3: the bucket fold of ``LimbPrescaledMat``, int32 [K*R, cols]
    (K = 32 unsigned, 33 signed) -> canonical limbs int32 [R, cols, 8],
    or with ``transpose_out`` [cols, R, 8]."""
    name = "limb_fold"
    if not isinstance(V, torch.Tensor) or V.dtype != torch.int32 \
            or V.dim() != 2 or not V.is_contiguous():
        raise TypeError(f"{name}: buckets must be a contiguous 2-D int32 "
                        "tensor")
    K = 33 if signed else 32
    if R <= 0 or V.shape[0] != K * R:
        raise ValueError(f"{name}: expected {K}*R = {K * R} bucket rows, "
                         f"got {V.shape[0]}")
    cols = V.shape[1]
    if not _build.on_cuda(name, V):
        return limb_fold_ref(V, R, signed=signed, transpose_out=transpose_out)
    if R > 65535 or (cols + 255) // 256 >= 2**31:
        raise ValueError(f"{name}: shape {tuple(V.shape)} exceeds the grid")
    shape = (cols, R, L) if transpose_out else (R, cols, L)
    out = torch.empty(shape, dtype=torch.int32, device=V.device)
    if cols == 0:
        return out
    _build.launch(LAUNCHES, name, _build.kernels().srt_limb_fold, V.device,
                  V.data_ptr(), out.data_ptr(), R, cols, int(signed),
                  int(transpose_out))
    return out
