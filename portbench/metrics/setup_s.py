"""setup_s: seconds from the process's start to the first timed call:
imports, the kernel library's build or load, the program's tables, the
seeded inputs and the warm-up calls."""


def read(st):
    return st.setup_s
