"""Device time per call of everything that is neither a kernel of the
program nor a copy: the column applies' gathers and GEMMs, the update's
elementwise work and the reductions (library kernels), ms."""


def read(trace, cell):
    return trace.ms_per_call(trace.is_aten)
