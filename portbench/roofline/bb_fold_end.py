"""K4 ``bb_fold_end`` (``csrc/fold_bb.cu``): int32 buckets [K R, cols] (K
= 4 unsigned, 5 signed) folded mod q with one REDC, out u32 Montgomery
storage [R, cols].  ``args`` are the launch's C arguments: (V, ldv, out,
R, cols, signed)."""


def cost(args):
    rows, cols, signed = args[3], args[4], args[5]
    k = 5 if signed else 4
    return {"ops": 0, "bytes": 4 * k * rows * cols + 4 * rows * cols}
