"""digit_gemm_roofline.<group>: the traced GEMMs' least time at the
card's peaks (each GEMM the larger of its int8 operations over the int8
rate and its bytes over the HBM bandwidth, from ``roofline/int_mm.py``
and the shapes the profiler recorded) over their device time, in %.
A GEMM whose kernels the profiler lost is left out of both sums."""

from portbench.harness import roofline_module


def read(st):
    t, peaks = st.trace, st.peaks
    if t is None or peaks is None or not t.gemm:
        return None
    cost = roofline_module("int_mm").cost
    bound = seconds = 0.0
    for shapes, s in t.gemm:
        c = cost(shapes)
        bound += max(c["ops"] / peaks["int8_ops_per_s"],
                     c["bytes"] / peaks["hbm_bytes_per_s"])
        seconds += s
    return 100.0 * bound / seconds if seconds > 0 else None
