"""Offline debug visualization.

A copy of the JAX package's `utils/viz.py` that also takes tensors (on
any device). The reference renders three live OpenCV windows per frame —
"Stereo", "Temporal", "Tracking" (ref `src/visual_odometer.cpp:31-33,
197-200,294-296,327-332`). The equivalent here renders the same three views
to PNG files on demand (PIL, no GUI): detected keypoints, stereo matches as
side-by-side join lines, temporal matches, and tracked (RANSAC-inlier)
features highlighted.
"""

from __future__ import annotations

import os

import numpy as np


def _np(x):
    """A NumPy array of an array or a tensor on any device."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _to_rgb(img):
    from PIL import Image

    arr = np.clip(_np(img), 0, 255).astype(np.uint8)
    return Image.fromarray(arr).convert("RGB")


def draw_keypoints(img, xy, valid, highlight_mask=None, path=None):
    """Tracking view: all keypoints teal, highlighted (tracked) ones green
    (colors per ref visual_odometer.cpp:198-199)."""
    from PIL import ImageDraw

    im = _to_rgb(img)
    d = ImageDraw.Draw(im)
    xy = _np(xy)
    valid = _np(valid)
    hl = np.zeros_like(valid) if highlight_mask is None else _np(highlight_mask)
    for i in np.where(valid)[0]:
        x, y = float(xy[i, 0]), float(xy[i, 1])
        color = (0, 255, 0) if hl[i] else (150, 150, 0)
        d.ellipse([x - 3, y - 3, x + 3, y + 3], outline=color)
    if path:
        im.save(path)
    return im


def draw_matches(img_a, xy_a, img_b, xy_b, pairs, path=None):
    """Side-by-side match view (stereo or temporal): lines joining matched
    keypoints, like cv::drawMatches."""
    from PIL import Image, ImageDraw

    im_a = _to_rgb(img_a)
    im_b = _to_rgb(img_b)
    w = im_a.width + im_b.width
    h = max(im_a.height, im_b.height)
    canvas = Image.new("RGB", (w, h))
    canvas.paste(im_a, (0, 0))
    canvas.paste(im_b, (im_a.width, 0))
    d = ImageDraw.Draw(canvas)
    xy_a = _np(xy_a)
    xy_b = _np(xy_b)
    rng = np.random.default_rng(0)
    for (ia, ib) in pairs:
        xa, ya = float(xy_a[ia, 0]), float(xy_a[ia, 1])
        xb, yb = float(xy_b[ib, 0]) + im_a.width, float(xy_b[ib, 1])
        color = tuple(int(c) for c in rng.integers(64, 255, 3))
        d.line([xa, ya, xb, yb], fill=color, width=1)
        d.ellipse([xa - 2, ya - 2, xa + 2, ya + 2], outline=color)
        d.ellipse([xb - 2, yb - 2, xb + 2, yb + 2], outline=color)
    if path:
        canvas.save(path)
    return canvas


def save_frame_debug(folder, frame_idx, img_l, img_r, step_result,
                     prev_img=None, prev_slots=None):
    """Write the three reference debug views for one StepResult."""
    os.makedirs(folder, exist_ok=True)
    slots = step_result.slots
    valid = _np(slots.valid)
    kp_l = _np(slots.kp_l)
    kp_r = _np(slots.kp_r)

    # Stereo view: matched left/right keypoints.
    pairs = [(i, i) for i in np.where(valid)[0]]
    draw_matches(
        img_l, kp_l, img_r, kp_r, pairs,
        os.path.join(folder, f"stereo_{frame_idx:06d}.png"),
    )

    # Tracking view: all detections; tracked inliers highlighted.
    tracked = _np(step_result.tracked)
    draw_keypoints(
        img_l, kp_l, valid, tracked,
        os.path.join(folder, f"tracking_{frame_idx:06d}.png"),
    )

    # Temporal view (needs the previous image + slots).
    if prev_img is not None and prev_slots is not None:
        prev_idx = _np(step_result.prev_idx)
        pairs_t = [(i, int(prev_idx[i])) for i in np.where(tracked)[0]]
        draw_matches(
            img_l, kp_l, prev_img, _np(prev_slots.kp_l), pairs_t,
            os.path.join(folder, f"temporal_{frame_idx:06d}.png"),
        )
