"""S3 ``limb_fold`` (``csrc/stark.cu``): the digit GEMM's int32 buckets
[K R, cols] (K = 32 unsigned, 33 signed) folded into canonical limbs
[R, cols, 8] (or [cols, R, 8]).  Operations: the SASS instructions of
one thread (one column of one row) of the compiled kernel, 535
(``chip_smoke.py`` ``STARK_INSTRUCTIONS``).  ``args`` are the launch's C
arguments: (V, out, R, cols, signed, transpose_out)."""

INSTRUCTIONS = 535


def cost(args):
    rows, cols, signed = args[2], args[3], args[4]
    k = 33 if signed else 32
    return {"ops": INSTRUCTIONS * rows * cols,
            "bytes": 4 * k * rows * cols + 32 * rows * cols}
