"""``bb_step_digits`` (``csrc/digits.cu``): the BabyBear folding step's
digit stage in one pass, coeff [D, W, L] u32 Montgomery words -> the
digits [D, W, L k], each witness's L2 sum and psi count (an int64 pair a
witness), reading psi's D-entry table when psi is on.  Operations: the
digits made, D W L k.  ``args`` are the launch's C arguments: (coeff, dt,
tbl, D, W, L, k, base, shift, psi, partials, tickets, out)."""

WORD = 4


def cost(args):
    D, W, L, k, psi = args[3], args[4], args[5], args[6], args[9]
    return {"ops": D * W * L * k,
            "bytes": WORD * (D * W * L * (1 + k) + (D if psi else 0))
            + 16 * W}
