"""torch_ops_ms.<group>: device milliseconds a traced call in PyTorch's
own kernels, copies and fills: every device operation that is neither a
GEMM nor a hand kernel of the program."""


def read(st):
    t = st.trace
    if t is None or t.busy_s <= 0 or t.torch_s <= 0:
        return None
    return t.torch_s / t.calls * 1e3
