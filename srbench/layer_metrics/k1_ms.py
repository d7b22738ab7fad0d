"""Device time per call of the row apply K1 (``csrc/banded_rows.cu``:
the kernels named ``banded_rows*``), ms."""


def is_k1(trace, name):
    return (trace.port_kernel(name) or "").startswith("banded_rows")


def read(trace, cell):
    return trace.ms_per_call(lambda name: is_k1(trace, name))
