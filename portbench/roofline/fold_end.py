"""K3 ``fold_end`` (``csrc/fold.cu``): int32 buckets [K R, cols] (K = 8
unsigned, 9 signed) folded mod q, out u64 [R, cols].  ``args`` are the
launch's C arguments: (V, ldv, out, R, cols, signed)."""


def cost(args):
    rows, cols, signed = args[3], args[4], args[5]
    k = 9 if signed else 8
    return {"ops": 0, "bytes": 4 * k * rows * cols + 8 * rows * cols}
