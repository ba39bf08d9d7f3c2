"""``slot_matvec`` (``csrc/slot.cu``): the Ajtai commit's contraction
over Goldilocks slots, A [N, 3, n, m] and x [N, 3, W, m] -> out
[3N, W, n]; nine products of 64-bit words for each of the N n W m
extension products.  ``args`` are the launch's C arguments: (A, x, out,
N, n, W, m, chunk, chunks, tiles_n, tiles, nr, partials, tickets)."""


def cost(args):
    N, n, W, m = args[3], args[4], args[5], args[6]
    return {"ops": 9 * N * n * W * m,
            "bytes": 8 * 3 * N * (m * (n + W) + W * n)}
