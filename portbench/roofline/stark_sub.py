"""S2 ``stark_sub`` (``csrc/stark.cu``): a - b mod q on
rows of eight u32 limbs, a [rows, 8] and b [b_rows, 8] read at row mod
b_rows (b read once), out [rows, 8].  Operations: the SASS instructions
of one thread (one row) of the compiled kernel, 191 (``chip_smoke.py``
``STARK_INSTRUCTIONS``), a row.  ``args`` are the launch's C arguments:
(a, b, b_rows, out, rows)."""

INSTRUCTIONS = 191


def cost(args):
    b_rows, rows = args[2], args[4]
    return {"ops": INSTRUCTIONS * rows, "bytes": 32 * (2 * rows + b_rows)}
