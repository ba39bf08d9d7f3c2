"""``bb_slot_mul`` (``csrc/slot_bb.cu``): the BabyBear slot product of a
[N, 9, Ba] and b [N, 9, Ba or 1] (b read at j mod its batch), out
[9N, Ba], u32 words; 81 products of 32-bit words an extension product.
``args`` are the launch's C arguments: (a, b, out, N, Ba, bcast, vec,
nr)."""


def cost(args):
    n, ba, bcast = args[3], args[4], args[5]
    bb = 1 if bcast else ba
    return {"ops": 81 * n * ba, "bytes": 4 * 9 * n * (2 * ba + bb)}
