"""K1 ``fold_tw`` (``csrc/fold.cu``): int32 buckets [K R, cols] (K = 8
unsigned, 9 signed) folded mod q and times the twiddles [R, t], out u64
[R, cols] or its transpose.  ``args`` are the launch's C arguments:
(V, ldv, tw, t, out, R, cols, transpose_out, signed)."""


def cost(args):
    t, rows, cols, signed = args[3], args[5], args[6], args[8]
    k = 9 if signed else 8
    return {"ops": 0, "bytes": 4 * k * rows * cols + 8 * rows * t
            + 8 * rows * cols}
