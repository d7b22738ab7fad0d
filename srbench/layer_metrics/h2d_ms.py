"""Host-to-device copy time per call (the frames' upload in the solve
entry's ``_prepare``), ms."""


def read(trace, cell):
    return trace.ms_per_call(lambda name: name.startswith("Memcpy HtoD"))
