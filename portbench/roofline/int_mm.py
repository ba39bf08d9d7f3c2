"""``torch._int_mm``: int8 [M, K] x int8 [K, N] -> int32 [M, N]; one
multiply and one add a term; each operand read once, the product
written once.  ``shapes`` as the profiler records them."""


def cost(shapes):
    (m, k), (k2, n) = shapes[0], shapes[1]
    if k != k2:
        raise ValueError(f"int_mm: inner sizes {k} and {k2} differ")
    return {"ops": 2 * m * k * n, "bytes": m * k + k * n + 4 * m * n}
