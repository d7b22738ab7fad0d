"""From process start to the first timed call: imports, the kernels'
build or load, operators from the disk cache, the session pool, one warm
call of the cell's shape, s."""


def read(window, cell):
    return window.setup_s
