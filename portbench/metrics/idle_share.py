"""idle_share.<group>: 1 - busy / wall over the traced stretch, where
busy is the union of the device operations' intervals."""


def read(st):
    t = st.trace
    if t is None or t.busy_s <= 0:
        return None
    return 1.0 - t.busy_s / t.window_s
