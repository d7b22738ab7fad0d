"""The fused IBP iterations' work in one call (K2 and K3 launches,
``_fused_work`` of the program's smoke script, counted from the
benchmark's operators)."""

from typing import Dict, Tuple

from . import calls
from .nonzeros import distinct, nonzeros
from .peaks import BYTES, bound_s


def iteration_work(cfg: Dict, traffic: Dict, ops,
                   store: str) -> Tuple[Tuple[float, float],
                                        Tuple[float, float]]:
    """One iteration's (FLOPs, bytes) of the forward errors (K2) and of the
    back-projected update (K3).  K2 forms each distinct row operator's
    product of hr once and each frame's column product; K3 each frame's row
    and column products of its error.  Images are read and written once
    (hr in float32, the frames and errors in the store's type), each
    distinct band once."""
    r = calls.units_per_call(cfg, traffic)
    f = cfg["factor"]
    h, w = cfg["lr_shape"]
    hh, ww = h * f, w * f
    oy, ox = ops["y"], ops["x"]
    n = len(cfg["shifts"])
    io = BYTES[store]
    hr = 4.0 * r * hh * ww
    stack = float(io * n * r * h * w)

    def bands(mats):
        return BYTES[store] * sum(nonzeros(m) for m in distinct(mats))

    k2_flops = (sum(2.0 * r * nonzeros(m) * ww for m in distinct(oy["fwd"]))
                + sum(2.0 * r * h * nonzeros(m) for m in ox["fwd"]))
    k2_bytes = hr + 2 * stack + bands(oy["fwd"]) + bands(ox["fwd"])
    k3_flops = sum(2.0 * r * nonzeros(oy["bwd"][i]) * w
                   + 2.0 * r * hh * nonzeros(ox["bwd"][i]) for i in range(n))
    k3_bytes = 2 * hr + stack + bands(oy["bwd"]) + bands(ox["bwd"])
    return (k2_flops, k2_bytes), (k3_flops, k3_bytes)


def bound_ms(cfg: Dict, traffic: Dict, ops) -> float:
    """The least time the call's fused iterations could take on the card
    (ms): per iteration K2's bound plus K3's, each by its operations or its
    bytes."""
    total = 0.0
    for engine, store, its in calls.ibp_segments(cfg, traffic):
        if engine != "fused":
            continue
        k2, k3 = iteration_work(cfg, traffic, ops, store)
        total += its * (bound_s(*k2, store) + bound_s(*k3, store))
    return 1e3 * total
