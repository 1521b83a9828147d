"""The DLT of n pixel pairs through two [3, 4] projections in float64,
counted from one fixed method whatever the design that computes it: the
cyclic one-sided Jacobi SVD (pairs (0,1) (0,2) (0,3) (1,2) (1,3) (2,3), a
pair rotated when its columns' cosine exceeds 1e-15, at most 16 sweeps) on
the float64 systems of the inputs. Operations (adds, multiplies, divisions
and square roots, an FMA as two): 99 a point (the system, its norm, the
column norms and the division), 162 a sweep (six pair tests of three
4-term dot products each) and 60 a rotation (the angle and two 4-row
column updates of A and of V), at the float64 rate, half the float32 one.
Bytes: both pixels (8 bytes each) read and the point (12 bytes) written
per pair, the two projections read once."""

import numpy as np

from portbench.roofline import F64_OPS_PER_S, bound

PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def systems(P1, P2, uv1, uv2) -> np.ndarray:
    """[n, 4, 4] float64 DLT systems of uv1, uv2 [n, 2] through P1, P2."""
    P1, P2, uv1, uv2 = (np.asarray(x, np.float64) for x in (P1, P2, uv1, uv2))
    rows = [uv[:, c:c + 1] * P[2] - P[c] for P, uv in ((P1, uv1), (P2, uv2)) for c in (0, 1)]
    return np.stack(rows, axis=1)


def jacobi_work(a: np.ndarray):
    """(sweeps [n], rotations [n]) of the cyclic one-sided Jacobi on the
    systems a [n, 4, 4] (float64)."""
    a = np.array(a, np.float64)
    m = a.shape[0]
    abs_tol = 1e-30 * (a * a).sum((1, 2))
    active = np.ones(m, bool)
    sweeps, rotations = np.zeros(m, np.int64), np.zeros(m, np.int64)
    for _ in range(16):
        if not active.any():
            break
        sweeps += active
        rotated = np.zeros(m, bool)
        for p, q in PAIRS:
            ap, aq = a[:, :, p], a[:, :, q]
            alpha, beta, gamma = (ap * ap).sum(1), (aq * aq).sum(1), (ap * aq).sum(1)
            do = (active & (gamma * gamma > 1e-15 * 1e-15 * alpha * beta)
                  & (np.abs(gamma) > abs_tol))
            g = np.where(do, gamma, 1.0)
            zeta = (beta - alpha) / (2.0 * g)
            t = np.copysign(1.0, zeta) / (np.abs(zeta) + np.sqrt(1.0 + zeta * zeta))
            c = np.where(do, 1.0 / np.sqrt(1.0 + t * t), 1.0)[:, None]
            s = np.where(do, c[:, 0] * t, 0.0)[:, None]
            a[:, :, p], a[:, :, q] = c * ap - s * aq, s * ap + c * aq
            rotated |= do
            rotations += do
        active &= rotated
    return sweeps, rotations


def bound_s(P1, P2, uv1, uv2):
    """The bound of one call on pixel pairs uv1, uv2 [n, 2]."""
    sweeps, rotations = jacobi_work(systems(P1, P2, uv1, uv2))
    n = len(sweeps)
    ops = 99 * n + 162 * int(sweeps.sum()) + 60 * int(rotations.sum())
    nbytes = n * (2 * 8 + 12) + 2 * 48
    return bound(ops, F64_OPS_PER_S, nbytes)
