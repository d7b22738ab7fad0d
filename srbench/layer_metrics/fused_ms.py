"""Device time per call of the fused iteration K2 + K3
(``csrc/fused_ibp.cu``: the kernels named ``fused_fwd*`` and
``fused_bwd*``), ms."""


def is_fused(trace, name):
    return (trace.port_kernel(name) or "").startswith(("fused_fwd",
                                                       "fused_bwd"))


def read(trace, cell):
    return trace.ms_per_call(lambda name: is_fused(trace, name))
