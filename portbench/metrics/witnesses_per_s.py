"""witnesses_per_s: W witnesses a folding step times the steps completed
in the window, over the window's seconds on the host clock."""


def read(st):
    return st.units * st.calls / st.window_s if st.calls else None
