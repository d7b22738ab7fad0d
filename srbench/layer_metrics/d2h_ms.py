"""Device-to-host copy time per call (``classical._to_host``), ms."""


def read(trace, cell):
    return trace.ms_per_call(lambda name: name.startswith("Memcpy DtoH"))
