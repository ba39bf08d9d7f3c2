"""hand_kernels_roofline.<group>: the program's hand kernels' least time
(each launch's bytes, read once and written once, from
``roofline/<launch name>.py`` and the launch's own arguments, at the
HBM bandwidth) over their device time, in %.  Each kernel counts as
many launches as the profiler recorded, at the mean bound of its
launches; a kernel with no roofline file is logged and left out."""

from portbench.harness import log, roofline_module


def read(st):
    t, peaks = st.trace, st.peaks
    if t is None or peaks is None or not t.hand:
        return None
    bound = seconds = 0.0
    for name, (seen, s) in t.hand.items():
        mod = roofline_module(name)
        args = [a for n, a in t.launches if n == name]
        if mod is None or not args:
            log(f"hand kernel {name}: no roofline file or no recorded "
                "launch; left out of hand_kernels_roofline")
            continue
        per = [mod.cost(a)["bytes"] / peaks["hbm_bytes_per_s"] for a in args]
        bound += sum(per) / len(per) * seen
        seconds += s
    return 100.0 * bound / seconds if seconds > 0 else None
