"""The row applies' work in one call (K1's launches, ``_k1_solve_launches``
of the program's smoke script, counted from the benchmark's operators)."""

from typing import Dict, List, Tuple

from . import calls
from .nonzeros import nonzeros
from .peaks import BYTES, bound_s

# x and the result of every row apply are float32, whatever the bands
XBYTES = 4


def launch_list(cfg: Dict, traffic: Dict, ops) -> List[Tuple[str, float,
                                                              float, str]]:
    """Every row apply of one call as (op, FLOPs, bytes, band store).  R
    units stacked along the rows share each operator; a band entry is one
    multiply-add for each column of x it meets, x and the result are read
    and written once, the band once."""
    r = calls.units_per_call(cfg, traffic)
    f = cfg["factor"]
    h, w = cfg["lr_shape"]
    hh, ww = h * f, w * f
    oy = ops["y"]
    n = len(cfg["shifts"])
    rows = traffic["launches"]["rows"]

    def apply(name, nnz, n_in, n_out, width, batch, store):
        flops = 2.0 * nnz * width * batch * r
        nbytes = (XBYTES * (n_in + n_out) * width * batch * r
                  + BYTES[store] * nnz)
        return (name, flops, nbytes, store)

    z = nonzeros(oy["zoom"])
    out = [apply("zoom_r_mean", z, h, hh, w, 1, rows),
           apply("zoom_r", z, h, hh, w, n, rows)]
    out += [apply("saa_r", nonzeros(oy["saa"][i]), hh, hh, ww, 1, rows)
            for i in range(n)]
    for engine, store, its in calls.ibp_segments(cfg, traffic):
        if engine != "banded":
            continue
        for i in range(n):
            out += its * [apply("fwd_r", nonzeros(oy["fwd"][i]), hh, h, ww,
                                1, store),
                          apply("bwd_r", nonzeros(oy["bwd"][i]), h, hh, w,
                                1, store)]
    return out


def bound_ms(cfg: Dict, traffic: Dict, ops) -> float:
    """The least time the call's row applies could take on the card, each
    launch bound by its operations or its bytes, summed (ms)."""
    return 1e3 * sum(bound_s(fl, nb, st)
                     for _, fl, nb, st in launch_list(cfg, traffic, ops))
