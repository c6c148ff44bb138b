"""The least time the Gram kernels could take on one NVIDIA H100: a frozen
copy of ``chip_smoke.py``'s ``bound_ms`` with its peaks and its operation
counts, so that the roofline shares the benchmark reports stay comparable
while the program and its smoke test change.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit: HBM3
bandwidth, FP64 and FP32 outside the tensor cores, FP64 on the tensor cores.
"""
from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {8: 34e12, 4: 67e12}
PEAK_FLOPS_F64_MMA = 67e12
# f64 operations per distinct Gram entry: 3 per dimension for the distance,
# ~20 for the exp and the scaling; the backward ~5 more for the weight on
# the vector units, and its lengthscale sums as a product on the FP64
# tensor cores (one FMA per dimension and entry, the row sums as a column of
# ones)
FWD_OPS = (3, 20)
BWD_OPS = (3, 25)
BWD_MMA_OPS = (2, 2)
# the coordinate variant: the same vector work, and on the tensor cores its
# two products W xs and W^T xs with the row and column sums of W
BWD_X_OPS = BWD_OPS
BWD_X_MMA_OPS = (4, 4)


def bound_ms(kind, cap, d, lanes, itemsize=8, per_lane=False):
    """The least time for one launch: each input read once and each output
    written once at the HBM rate, the vector operations on the
    cap (cap + 1) / 2 distinct entries at the FP64 (FP32) peak, or the
    backwards' products at the FP64 tensor-core peak, whichever is largest.
    ``kind``: forward, backward or backward_x. Returns (ms, "bytes" or
    "operations")."""
    per_dim, fixed = {"forward": FWD_OPS, "backward": BWD_OPS,
                      "backward_x": BWD_X_OPS}[kind]
    inputs = (lanes if per_lane else 1) * cap * d + cap + lanes * (d + 1)
    big = lanes * cap * cap
    outputs = {"forward": 0, "backward": lanes * (d + 1),
               "backward_x": lanes * (d + 1) + lanes * cap * d}[kind]
    nbytes = itemsize * (inputs + big + outputs)
    entries = lanes * cap * (cap + 1) / 2
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = entries * (per_dim * d + fixed) / PEAK_FLOPS[itemsize] * 1e3
    if kind != "forward":
        mma_dim, mma_fixed = {"backward": BWD_MMA_OPS,
                              "backward_x": BWD_X_MMA_OPS}[kind]
        t_ops = max(t_ops, entries * (mma_dim * d + mma_fixed)
                    / PEAK_FLOPS_F64_MMA * 1e3)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
