"""Hamming top-2 of n packed 256-bit query descriptors against `sets`
train sets of m descriptors each, with the train rows' validity: the +-1
dot product of depth 256 for every (query, train) pair at the int8
tensor-core rate (a multiply-add as two operations); bytes: the queries
and each set's descriptors and validity read once, each set's (d1, idx1,
d2) written once (12 bytes a query)."""

from portbench.roofline import INT8_TENSOR_OPS_PER_S, bound


def bound_s(n: int = 1024, m: int = 1024, sets: int = 2, batch: int = 1):
    ops = batch * sets * 2 * n * m * 256
    nbytes = batch * (n * 32 + sets * (m * 32 + m + n * 12))
    return bound(ops, INT8_TENSOR_OPS_PER_S, nbytes)
