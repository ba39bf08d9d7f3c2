"""``slot_mul`` (``csrc/slot.cu``): the Goldilocks slot product of a
[N, 3, Ba] and b [N, 3, Ba or 1] (b read at j mod its batch), out
[3N, Ba]; nine products of 64-bit words an extension product.  ``args``
are the launch's C arguments: (a, b, out, N, Ba, bcast, vec, nr)."""


def cost(args):
    n, ba, bcast = args[3], args[4], args[5]
    bb = 1 if bcast else ba
    return {"ops": 9 * n * ba, "bytes": 8 * 3 * n * (2 * ba + bb)}
