"""Share of the traced stretch in which no operation ran on the device, %:
1 - (the union of device intervals) / (the stretch's wall time)."""


def read(trace, cell):
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
