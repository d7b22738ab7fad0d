"""HR megapixels returned to the host (``ibp``: units x 2h x 2w a call)
over all completed calls of the window, per second of the window's wall
time."""


def read(window, cell):
    return window.hr_pixels / 1e6 / window.seconds
