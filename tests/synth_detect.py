"""Test images for the Shi-Tomasi detector, free of JAX.

`detect_images(rng, kinds, h, w)` gives float32 [len(kinds), h, w] images of
three kinds:

- "flat": uniform noise with flat patches (NMS over flat ground, tiles
  with no survivor);
- "lattice": a texture that repeats 5 rows down and 4 columns across,
  where the jitter of two equal responses differs by 136 / 65521 of its
  scale, below half an ulp of most responses, so window maxima tie;
- "constant": no response at all, so every slot is invalid.

The CPU model test, the card test and `chip_smoke.py` share them.
"""

from __future__ import annotations

import numpy as np


def detect_images(rng, kinds, h, w):
    out = np.empty((len(kinds), h, w), np.float32)
    for i, kind in enumerate(kinds):
        if kind == "flat":
            img = rng.uniform(0, 255, (h, w))
            for _ in range(max(3, h * w // 40000)):
                ph, pw = rng.integers(h // 10, h // 3), rng.integers(w // 10, w // 3)
                y, x = rng.integers(0, h - ph), rng.integers(0, w - pw)
                img[y:y + ph, x:x + pw] = rng.uniform(0, 255)
        elif kind == "lattice":
            yy, xx = np.mgrid[:h, :w]
            img = rng.uniform(0, 255, 37)[(4 * yy - 5 * xx) % 37]
        elif kind == "constant":
            img = np.full((h, w), 100.0)
        else:
            raise ValueError(f"unknown image kind {kind!r}")
        out[i] = img
    return out
