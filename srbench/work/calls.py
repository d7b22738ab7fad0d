"""The structure of one call, as the traffic mix routes it: how many units
it solves and which kernels run how often (the launch plan the path check
holds each call to, and the launches the rooflines count)."""

from typing import Dict, List, Tuple

# the launch counter of each store, on each kernel wrapper
SUFFIX = {"f32": "launches", "bf16": "launches_bf16"}


def units_per_call(cfg: Dict, traffic: Dict) -> int:
    """Units one call solves: a session's units, up to the mix's
    ``max_batch`` (``sr.pipeline.process_workload`` batches so)."""
    return min(cfg["units_per_session"], traffic["max_batch"])


def ibp_segments(cfg: Dict, traffic: Dict) -> List[Tuple[str, str, int]]:
    """The IBP loop's segments in order: (engine, store, iterations), an
    iteration count of 0 taking the iterations left."""
    left = cfg["ibp"]["iterations"]
    out = []
    for engine, store, its in traffic["launches"]["ibp"]:
        its = left if its == 0 else min(its, left)
        out.append((engine, store, its))
        left -= its
    return out


def launches(cfg: Dict, traffic: Dict) -> Dict[str, int]:
    """Each kernel wrapper's launches in one call, by counter name: the
    mean's and the stack's zoom and a Shift-and-Add row apply per frame
    (K1, on the mix's ``rows`` store), then per IBP iteration a forward
    and a back-projection row apply per frame (banded engine; the PSF is
    one separable term) or one K2 and one K3 launch (fused engine)."""
    n = len(cfg["shifts"])
    rows = "banded_row_apply." + SUFFIX[traffic["launches"]["rows"]]
    out = {rows: 2 + n}
    for engine, store, its in ibp_segments(cfg, traffic):
        if engine == "banded":
            key = "banded_row_apply." + SUFFIX[store]
            out[key] = out.get(key, 0) + its * n * 2
        else:
            for fn in ("fused_fwd_err", "fused_bwd_update"):
                key = f"{fn}.{SUFFIX[store]}"
                out[key] = out.get(key, 0) + its
    return out
