"""``pointwise_mul`` (``csrc/fold.cu``): u64 a [n] times b [n_b] (read at
i mod n_b) mod q, out [n].  ``args`` are the launch's C arguments:
(a, b, out, n, n_b)."""


def cost(args):
    n, n_b = args[3], args[4]
    return {"ops": n, "bytes": 8 * (2 * n + n_b)}
