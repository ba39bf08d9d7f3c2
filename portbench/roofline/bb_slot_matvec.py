"""``bb_slot_matvec`` (``csrc/slot_bb.cu``): the Ajtai commit's
contraction over BabyBear slots, A [N, 9, n, m] and x [N, 9, W, m] -> out
[9N, W, n], u32 words; 81 products of 32-bit words for each of the
N n W m extension products.  ``args`` are the launch's C arguments: (A,
x, out, N, n, W, m, chunk, chunks, tiles_n, tiles, nr, partials,
tickets)."""


def cost(args):
    N, n, W, m = args[3], args[4], args[5], args[6]
    return {"ops": 81 * N * n * W * m,
            "bytes": 4 * 9 * N * (m * (n + W) + W * n)}
