"""The canyon drive seen through a distorted, unrectified stereo rig.

`portbench/scene/canyon.py`'s canyon (its planes, textures, exposure drift
and sensor noise, imported, not copied), each pixel of each camera read
along the ray of its ideal (undistorted) coordinates: a distorted pixel is
undistorted once, by the fixed-point inversion of the radial-tangential
model that `scene/plane.py` runs (`ideal`), and its ray is traced through
`CanyonScene.trace` as the ideal pixel (cx + fx xn, cy + fx yn): `trace`
divides both axes by fx, so the ray is (xn, yn, 1) and fy is honoured.
Both cameras share the intrinsics and distortion, the right one the
baseline along x (the EuRoC configuration's assumption), so one grid of
ideal pixels serves both eyes. Imports nothing of the program.
"""

from __future__ import annotations

import torch

from portbench.scene.canyon import CanyonScene

# Fixed-point iterations of the inversion: plane.py's 10 leave up to 2.6e-3
# px at the corners of EuRoC's cam0 (k1 -0.283); 30 leave under 2e-12 px.
ITERATIONS = 30


def ideal(uu, vv, fx, fy, cx, cy, dist):
    """Normalised ideal coordinates (xn, yn) of distorted pixels (uu, vv)
    (float64), by `scene/plane.py`'s fixed-point inversion of the model
    `dist` = (k1, k2, p1, p2, k3), and the distorted ones (x0, y0)."""
    x0 = (uu - cx) / fx
    y0 = (vv - cy) / fy
    k1, k2, p1, p2, k3 = (float(v) for v in dist)
    x, y = x0.clone(), y0.clone()
    for _ in range(ITERATIONS):
        r2 = x * x + y * y
        rad = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x, y = (x0 - dx) / rad, (y0 - dy) / rad
    return x, y, x0, y0


class DistortedCanyonScene(CanyonScene):
    """`CanyonScene` through cameras of intrinsics (fx, fy, cx, cy) and
    distortion `dist`. Its pixel grid is the ideal pixels' (see the
    module's docstring), written as offsets from the distorted pixels,
    u + fx (xn - x0) and v + (fx yn - fy y0), which are cx + fx xn and
    cy + fx yn up to rounding and, at zero distortion with fy = fx, the
    pixels themselves bit for bit (so the scene is the canyon's)."""

    def __init__(self, textures: torch.Tensor, fx: float, fy: float, cx: float, cy: float,
                 baseline: float, h: int, w: int, dist, noise_sigma: float = 0.0,
                 illum_drift: float = 0.0):
        super().__init__(textures, fx, cx, cy, baseline, h, w, noise_sigma, illum_drift)
        fx, fy = self.fx, float(fy)
        uu, vv = self._uu, self._vv
        xn, yn, x0, y0 = ideal(uu, vv, fx, fy, self.cx, self.cy, dist)
        self._uu = uu + fx * (xn - x0)
        self._vv = vv + (fx * yn - fy * y0)
