"""host_ms.<group>: the mean host time of a window call from its start
to its return, before the wait for the device: the entry's Python, the
wrappers and the torch dispatcher.  Taken on the untraced window."""

import statistics


def read(st):
    return statistics.fmean(st.host_ms) if st.host_ms else None
