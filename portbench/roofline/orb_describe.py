"""The upright ORB describe of n corners on one smoothed image padded by 15
pixels ([hp, wp] float32): bytes: the padded image, the corners (8 bytes)
and their validity (1 byte) read once, n 32-byte descriptors written once;
operations: each of the 512 test points of a corner read as 4 bilinear
taps, a multiply-add each (two operations), in float32."""

from portbench.roofline import F32_OPS_PER_S, bound

TAPS = 4
TESTS = 256


def bound_s(hp: int, wp: int, n: int = 1024, batch: int = 1):
    nbytes = batch * (hp * wp * 4 + n * (8 + 1) + n * 32)
    ops = batch * 2 * (n * 2 * TESTS * TAPS)
    return bound(ops, F32_OPS_PER_S, nbytes)
