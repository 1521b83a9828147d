"""EuRoC MAV's distorted stereo plane, rendered on the card.

A PyTorch copy of `tests/synth_distorted.py::DistortedPlaneScene` through
EuRoC cam0's model (`euroc_scene`), with the tangential terms and fy of the
model added: a textured plane facing the rig, each distorted pixel
undistorted by fixed-point iteration and its ray read on the plane
(bilinear, edges clamped). The texture is uniform noise on a
512 x 512 grid, each value repeated over 8 x 8 texels, blurred with a
Gaussian of sigma 1, drawn from a `torch.Generator` on the card. Imports
nothing of the program.
"""

from __future__ import annotations

import torch

from portbench.scene.canyon import gaussian_blur


def make_texture(generator: torch.Generator, grid: int = 512, repeat: int = 8,
                 sigma: float = 1.0) -> torch.Tensor:
    """[grid * repeat, grid * repeat] float32 texture on the generator's
    device."""
    tex = torch.rand((1, grid, grid), generator=generator, device=generator.device) * 255.0
    tex = tex.repeat_interleave(repeat, dim=1).repeat_interleave(repeat, dim=2)
    return gaussian_blur(tex, sigma)[0]


class DistortedPlaneScene:
    """A plane at `depth` metres seen by two cameras with the
    radial-tangential distortion `dist` (k1, k2, p1, p2, k3) and a baseline
    along x; frames differ by the rig's x. `fy` defaults to `fx`."""

    def __init__(self, texture: torch.Tensor, fx, cx, cy, baseline, depth, h, w, dist,
                 fy=None, tex_scale: float = 0.02):
        self.fx, self.cx, self.cy = float(fx), float(cx), float(cy)
        self.fy = self.fx if fy is None else float(fy)
        self.baseline, self.depth = float(baseline), float(depth)
        self.h, self.w = int(h), int(w)
        self.dist = [float(v) for v in dist]
        self.tex = texture
        self.tex_scale = float(tex_scale)
        self.device = texture.device

    def _ideal(self, uu, vv):
        """Undistorted normalised coordinates of distorted pixels, by the
        fixed-point inversion of the model."""
        x0 = (uu - self.cx) / self.fx
        y0 = (vv - self.cy) / self.fy
        k1, k2, p1, p2, k3 = self.dist
        x, y = x0.clone(), y0.clone()
        for _ in range(10):
            r2 = x * x + y * y
            rad = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
            dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
            dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
            x, y = (x0 - dx) / rad, (y0 - dy) / rad
        return x, y

    def render(self, cam_x: float, right: bool = False) -> torch.Tensor:
        """[h, w] float32 image of the camera at x = cam_x (+ the baseline
        for the right one)."""
        ox = cam_x + (self.baseline if right else 0.0)
        vv, uu = torch.meshgrid(torch.arange(self.h, dtype=torch.float32, device=self.device),
                                torch.arange(self.w, dtype=torch.float32, device=self.device),
                                indexing="ij")
        xu, yu = self._ideal(uu, vv)
        n_r, n_c = self.tex.shape
        tx = (xu * self.depth + ox) / self.tex_scale + n_c / 2
        ty = (yu * self.depth) / self.tex_scale + n_r / 2
        # map_coordinates(order=1, mode="nearest"): coordinates clamped.
        tx = tx.clamp(0, n_c - 1)
        ty = ty.clamp(0, n_r - 1)
        c0 = torch.floor(tx).long().clamp(max=n_c - 2)
        r0 = torch.floor(ty).long().clamp(max=n_r - 2)
        fc = tx - c0
        fr = ty - r0
        flat = self.tex.reshape(-1)
        i00 = r0 * n_c + c0
        top = flat[i00] * (1 - fc) + flat[i00 + 1] * fc
        bot = flat[i00 + n_c] * (1 - fc) + flat[i00 + n_c + 1] * fc
        return top * (1 - fr) + bot * fr

    def render_pairs(self, xs) -> torch.Tensor:
        """uint8 [N, 2, h, w] stereo pairs at rig positions xs."""
        out = torch.empty((len(xs), 2, self.h, self.w), dtype=torch.uint8, device=self.device)
        for f, x in enumerate(xs):
            for eye in (0, 1):
                out[f, eye] = self.render(float(x), bool(eye)).clamp(0, 255).to(torch.uint8)
        return out
