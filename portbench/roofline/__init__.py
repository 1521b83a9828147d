"""Frozen operation and byte counts of the port's hand kernels, one module
per kernel, and the published peaks of one NVIDIA H100 SXM (NVIDIA's data
sheet, dense rates, at the full 700 W power limit).

Each count is the work of the *function* at the cell's shapes, whatever
the design that computes it: each input byte read once, each output byte
written once, and the operations that the function's definition needs.
A module defines `bound_s(**shape)`: the least time the chip could take,
the larger of operations over the peak rate and bytes over the peak
bandwidth, with `bound_by` saying which.
"""

HBM_BYTES_PER_S = 3.35e12          # HBM3
INT8_TENSOR_OPS_PER_S = 1.979e15   # dense int8 tensor-core rate
F32_OPS_PER_S = 67e12              # float32 outside the tensor cores
F64_OPS_PER_S = F32_OPS_PER_S / 2  # float64 outside the tensor cores


def bound(ops: float, ops_per_s: float, nbytes: float):
    """(seconds, "operations" or "bytes") of the larger of the two bounds."""
    t_ops, t_bytes = ops / ops_per_s, nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
