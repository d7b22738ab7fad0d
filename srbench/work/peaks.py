"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates at its
700 W limit), the table every roofline share of the benchmark divides by."""

HBM_BYTES_PER_S = 3.35e12
# dense rates by the type the products take
FLOPS = {"f32": 66.9e12,    # CUDA cores (FMA); float64 tensor cores alike
         "bf16": 989e12,    # tensor cores
         "f16": 989e12}     # tensor cores, the same dense rate as bf16
# bytes of one element (a band entry, an image, err or activation element)
# by store
BYTES = {"f32": 4, "bf16": 2, "f16": 2}


def bound_s(flops: float, nbytes: float, store: str) -> float:
    """The least time one kernel launch could take: the larger of its
    operations over the store's peak and its bytes over HBM's."""
    return max(flops / FLOPS[store], nbytes / HBM_BYTES_PER_S)
