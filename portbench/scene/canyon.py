"""The canyon drive's scene and trajectories, rendered on the card.

A PyTorch copy of `tests/synth.py::CanyonScene` (five textured planes: the
ground, two side walls, a far wall and a near wall behind the start; each
pixel's ray cast onto the nearest plane in front of the eye; the texture
read by bilinear interpolation with wrap; the exposure drift; sensor
noise) and of the drive's trajectories (`loop_trajectory`,
`two_episode_trajectory`, as `tests/synth_canyon.py` copies them).

The textures come from a `torch.Generator` on the card that the caller
seeds (`make_textures`), the sensor noise from the one it hands to
`render_pairs`: the same seeds give the same frames.
Geometry runs in float64, as the NumPy scene's does; a frame leaves as
uint8, truncated as `astype(np.uint8)` truncates. Imports nothing of the
program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# (point, normal, up, metres per texel) of the default canyon's planes.
PLANES = (
    ((0.0, 1.6, 0.0), (0.0, -1.0, 0.0), (0.0, 0.0, 1.0), 0.030),
    ((-5.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), 0.035),
    ((6.0, 0.0, 0.0), (-1.0, 0.0, 0.0), (0.0, 1.0, 0.0), 0.035),
    ((0.0, 0.0, 45.0), (0.0, 0.0, -1.0), (0.0, 1.0, 0.0), 0.10),
    ((0.0, 0.0, -12.0), (0.0, 0.0, 1.0), (0.0, 1.0, 0.0), 0.05),
)


def gaussian_blur(tex: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian of [B, H, W] images, radius int(4 sigma + 0.5) as
    scipy's `gaussian_filter` truncates it, with the edges wrapped (the
    texture is read with wrap)."""
    r = int(4.0 * sigma + 0.5)
    x = torch.arange(-r, r + 1, dtype=torch.float64, device=tex.device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = (k / k.sum()).to(tex.dtype)
    out = tex[:, None]
    out = torch.nn.functional.pad(out, (r, r, 0, 0), mode="circular")
    out = torch.nn.functional.conv2d(out, k.view(1, 1, 1, -1))
    out = torch.nn.functional.pad(out, (0, 0, r, r), mode="circular")
    out = torch.nn.functional.conv2d(out, k.view(1, 1, -1, 1))
    return out[:, 0]


def make_textures(generator: torch.Generator, n: int = len(PLANES), tex_hw: int = 2048,
                  sigma: float = 2.0) -> torch.Tensor:
    """[n, tex_hw, tex_hw] float32 textures on the generator's device:
    uniform noise, blurred, stretched to [40, 216] per plane."""
    dev = generator.device
    tex = torch.rand((n, tex_hw, tex_hw), generator=generator, device=dev) * 255.0
    tex = gaussian_blur(tex, sigma)
    lo = tex.amin(dim=(1, 2), keepdim=True)
    hi = tex.amax(dim=(1, 2), keepdim=True)
    return 40.0 + 176.0 * (tex - lo) / (hi - lo)


def bilinear_wrap(tex: torch.Tensor, row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """`scipy.ndimage.map_coordinates(tex, [row, col], order=1, mode="wrap")`
    for coordinates in [0, n): scipy's "wrap" has period n - 1, so a
    coordinate past n - 1 reads from the start."""
    n_r, n_c = tex.shape
    row = torch.where(row >= n_r - 1, row - (n_r - 1), row)
    col = torch.where(col >= n_c - 1, col - (n_c - 1), col)
    r0 = torch.floor(row)
    c0 = torch.floor(col)
    fr = (row - r0).to(tex.dtype)
    fc = (col - c0).to(tex.dtype)
    r0 = r0.long().clamp(0, n_r - 2)
    c0 = c0.long().clamp(0, n_c - 2)
    flat = tex.reshape(-1)
    i00 = r0 * n_c + c0

    def at(i):
        return flat[i]

    top = at(i00) * (1 - fc) + at(i00 + 1) * fc
    bot = at(i00 + n_c) * (1 - fc) + at(i00 + n_c + 1) * fc
    return top * (1 - fr) + bot * fr


def illum_gain_bias(f: int, amplitude: float):
    """The exposure drift of frame f (both eyes alike): (gain, bias)."""
    if amplitude <= 0:
        return 1.0, 0.0
    return (1.0 + amplitude * math.sin(2 * math.pi * f / 41.0),
            24.0 * amplitude * math.sin(2 * math.pi * f / 59.0))


class CanyonScene:
    """The canyon of `tests/synth.py::CanyonScene` on a torch device.

    `textures` [5, T, T] float32 are the planes' textures (`make_textures`);
    the planes' geometry is `PLANES`."""

    def __init__(self, textures: torch.Tensor, fx: float, cx: float, cy: float,
                 baseline: float, h: int, w: int, noise_sigma: float = 0.0,
                 illum_drift: float = 0.0):
        self.fx, self.cx, self.cy = float(fx), float(cx), float(cy)
        self.baseline = float(baseline)
        self.h, self.w = int(h), int(w)
        self.noise_sigma = float(noise_sigma)
        self.illum_drift = float(illum_drift)
        self.textures = textures
        self.device = textures.device
        self.planes = []
        for point, normal, up, scale in PLANES:
            nrm = np.asarray(normal, np.float64)
            nrm = nrm / np.linalg.norm(nrm)
            e1 = np.cross(up, nrm).astype(np.float64)
            e1 /= np.linalg.norm(e1)
            e2 = np.cross(nrm, e1)
            self.planes.append(tuple(torch.as_tensor(v, dtype=torch.float64, device=self.device)
                                     for v in (point, nrm, e1, e2)) + (float(scale),))
        vv, uu = torch.meshgrid(torch.arange(self.h, dtype=torch.float64, device=self.device),
                                torch.arange(self.w, dtype=torch.float64, device=self.device),
                                indexing="ij")
        self._uu, self._vv = uu, vv

    def _eye_rays(self, T, right, uu, vv):
        T = torch.as_tensor(np.asarray(T, np.float64), device=self.device)
        R, t = T[:3, :3], T[:3, 3]
        eye = t + R[:, 0] * self.baseline if right else t
        rays = torch.stack([(uu - self.cx) / self.fx, (vv - self.cy) / self.fx,
                            torch.ones_like(uu)], dim=-1) @ R.T
        return R, eye, rays

    def trace(self, T_cam_to_world, right, uu, vv):
        """Ray-cast pixels (uu, vv) float64: (intensity float32, depth
        float64: z along the view axis, inf where no plane is hit)."""
        R, eye, rays = self._eye_rays(T_cam_to_world, right, uu, vv)
        img = torch.full(uu.shape, 96.0, dtype=torch.float32, device=self.device)
        depth = torch.full(uu.shape, math.inf, dtype=torch.float64, device=self.device)
        rz = rays @ R[:, 2]
        for (X0, nrm, e1, e2, ms), tex in zip(self.planes, self.textures):
            denom = rays @ nrm
            s = ((X0 - eye) @ nrm) / denom
            ok = (s > 0.2) & (denom.abs() > 1e-9)
            zc = s * rz
            hit = ok & (zc < depth) & (zc > 0.2)
            Y = eye + rays * torch.where(ok, s, 0.0)[..., None]
            d = Y - X0
            n_t = tex.shape[0]
            a1 = torch.remainder((d @ e1) / ms, n_t)
            a2 = torch.remainder((d @ e2) / ms, n_t)
            a1 = torch.where(hit, a1, 0.0)
            a2 = torch.where(hit, a2, 0.0)
            img = torch.where(hit, bilinear_wrap(tex, a2, a1), img)
            depth = torch.where(hit, zc, depth)
        return img, depth

    def render_pose(self, T_cam_to_world, right=False, generator=None, gain=1.0, bias=0.0):
        """[h, w] float32 image, clipped to [0, 255], noise drawn from
        `generator` (on the scene's device)."""
        img, _ = self.trace(T_cam_to_world, right, self._uu, self._vv)
        img = img * gain + bias
        if self.noise_sigma > 0:
            noise = torch.randn(img.shape, generator=generator, device=self.device,
                                dtype=torch.float64)
            img = (img.double() + self.noise_sigma * noise).float()
        return img.clamp(0, 255)

    def render_pairs(self, traj, generator):
        """uint8 [N, 2, h, w] stereo pairs of the poses `traj` [N, 4, 4] on
        the device, each frame's left then right noise drawn in order."""
        out = torch.empty((len(traj), 2, self.h, self.w), dtype=torch.uint8, device=self.device)
        for f, T in enumerate(traj):
            g, b = illum_gain_bias(f, self.illum_drift)
            for eye in (0, 1):
                out[f, eye] = self.render_pose(T, bool(eye), generator, g, b).to(torch.uint8)
        return out

    def depth(self, T_cam_to_world, uv, right=False):
        """[N] float64 depth (z in the camera) of pixels uv [N, 2]."""
        uv = torch.as_tensor(uv, dtype=torch.float64, device=self.device)
        return self.trace(T_cam_to_world, right, uv[:, 0], uv[:, 1])[1]


def loop_trajectory(n, side=4.0):
    """A closed square loop (4 legs, 90-degree yaw turns spread over the
    corners): [n, 4, 4] float32 camera-to-world poses, the copy of
    `tests/synth.py::loop_trajectory`."""
    per_leg = n // 4
    poses = []
    T = np.eye(4, dtype=np.float64)
    speed = side / per_leg
    turn_frames = max(3, per_leg // 4)
    yaw = np.deg2rad(90.0 / turn_frames)
    c, s = np.cos(yaw), np.sin(yaw)
    R_turn = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    for _leg in range(4):
        for i in range(per_leg):
            poses.append(T.copy())
            step = np.eye(4)
            step[2, 3] = speed
            if i >= per_leg - turn_frames:
                step[:3, :3] = R_turn
            T = T @ step
    while len(poses) < n:
        poses.append(T.copy())
    return np.asarray(poses[:n], np.float32)


def two_episode_trajectory(frames: int, side_a: float, side_b: float):
    """The drive's A A B A B A trajectory (1216 asked, 1200 given), the
    copy of `tests/synth_canyon.py::two_episode_trajectory`."""
    if frames >= 900:
        seg = max(16, frames // 6 // 4 * 4)
        tA = loop_trajectory(seg, side=side_a)
        tB = loop_trajectory(seg, side=side_b)
        traj = np.concatenate([tA, tA, tB, tA, tB, tA])
    else:
        seg = max(16, frames // 2 // 4 * 4)
        tA = loop_trajectory(seg, side=side_a)
        traj = np.concatenate([tA, tA])
    return traj[:frames]
