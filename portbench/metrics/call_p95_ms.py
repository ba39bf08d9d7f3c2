"""call_p95_ms: the nearest-rank 95th percentile of every window call's
time, read from the device's own timestamps: an event recorded as the
call starts (the stream has drained, the loop being closed) and one
after its last operation, recorded before the host waits for it."""

import math


def read(st):
    if not st.call_ms:
        return None
    s = sorted(st.call_ms)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]
