"""ring_mults_per_s: B products a call times the calls completed in the
window, over the window's seconds on the host clock."""


def read(st):
    return st.units * st.calls / st.window_s if st.calls else None
