"""Stereo dataset enumeration: KITTI, EuRoC, and suffix-paired folders.

A copy of the JAX package's `io/datasets.py`; its device batch reader
uploads with torch.

Mirrors ref `src/dataset.cpp`:
- KITTI: sorted listings of `image_0` / `image_1` (ref dataset.cpp:10-41).
- EuRoC: parse `mav0/cam{0,1}/data.csv`, pair rows by timestamp
  (ref dataset.cpp:43-114).
- Other: files ending `l.png` / `r.png` in one folder (ref dataset.cpp:116-146).

Image loading goes through the native C++ PNG decoder when built
(native/ — threaded prefetch), falling back to PIL.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

ImagePair = Tuple[str, str]


def load_dataset_kitti(folder: str) -> List[ImagePair]:
    left_dir = os.path.join(folder, "image_0")
    right_dir = os.path.join(folder, "image_1")
    lefts = sorted(
        os.path.join(left_dir, f) for f in os.listdir(left_dir)
    )
    rights = sorted(
        os.path.join(right_dir, f) for f in os.listdir(right_dir)
    )
    if len(lefts) != len(rights):
        raise ValueError(
            f"KITTI left/right count mismatch: {len(lefts)} vs {len(rights)}"
        )
    return list(zip(lefts, rights))


def load_dataset_euroc(folder: str) -> List[ImagePair]:
    def read_cam(cam: str):
        rows = []
        with open(os.path.join(folder, "mav0", cam, "data.csv")) as f:
            reader = csv.reader(f)
            next(reader, None)  # header
            for row in reader:
                if len(row) >= 2:
                    rows.append((row[0].strip(), row[1].strip()))
        return rows

    lefts = read_cam("cam0")
    rights = read_cam("cam1")
    pairs = []
    for (tl, nl), (tr, nr) in zip(lefts, rights):
        if tl == tr:
            pairs.append(
                (
                    os.path.join(folder, "mav0", "cam0", "data", nl),
                    os.path.join(folder, "mav0", "cam1", "data", nr),
                )
            )
        # mismatched rows are skipped with a warning in the reference
        # (ref dataset.cpp:109-112); we skip silently — count via len().
    return pairs


def load_dataset_other(folder: str) -> List[ImagePair]:
    lefts, rights = [], []
    for f in sorted(os.listdir(folder)):
        p = os.path.join(folder, f)
        if f.endswith("l.png"):
            lefts.append(p)
        elif f.endswith("r.png"):
            rights.append(p)
    if len(lefts) != len(rights):
        raise ValueError("left/right count mismatch")
    return list(zip(lefts, rights))


def load_dataset(name: str, folder: str) -> List[ImagePair]:
    """Dispatch by dataset name (ref slam.cpp:64-66 flag values)."""
    if name == "kitti":
        return load_dataset_kitti(folder)
    if name in ("EuRoc", "euroc"):
        return load_dataset_euroc(folder)
    if name == "other":
        return load_dataset_other(folder)
    raise ValueError(f"Unknown dataset '{name}'")


_native_loader = None
_native_checked = False


def _get_native_loader():
    global _native_loader, _native_checked
    if not _native_checked:
        _native_checked = True
        try:
            from stereo_orb_slam_torch.io import native_image

            _native_loader = native_image
        except Exception:
            _native_loader = None
    return _native_loader


def read_grayscale(path: str) -> np.ndarray:
    """[H, W] float32 grayscale image (0..255)."""
    nat = _get_native_loader()
    if nat is not None and path.lower().endswith(".png"):
        img = nat.read_png_gray(path)
        if img is not None:
            return img
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("L"), dtype=np.float32)


class PrefetchingReader:
    """Background-thread image-pair prefetcher (the reference reads images
    synchronously in the hot loop, ref slam.cpp:112-113; here the host
    overlaps decoding with device compute)."""

    def __init__(self, pairs: List[ImagePair], depth: int = 4):
        import queue
        import threading

        self.pairs = pairs
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.t = threading.Thread(target=self._worker, daemon=True)
        self.t.start()

    def _worker(self):
        for pl, pr in self.pairs:
            if self._stop.is_set():
                return
            self.q.put((read_grayscale(pl), read_grayscale(pr)))
        self.q.put(None)

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            yield item

    def close(self):
        self._stop.set()


class DeviceBatchReader:
    """Background-thread reader that decodes K-frame batches, stacks them as
    uint8 and uploads them to `device` from the reader thread, so decoding
    and the host-to-device copy overlap the main thread's work. uint8 (the
    camera's own type) moves a quarter of the bytes of float32; the front
    end casts on the device.

    `pairs` items are (path_l, path_r) or in-memory (img_l, img_r) arrays.
    Full K-batches are yielded as [K, H, W] uint8 tensors on `device`; a
    trailing remainder (< K frames) is left in `self.remainder` as host
    pairs once the iteration ends.
    """

    def __init__(self, pairs, batch: int, depth: int = 2, device="cuda"):
        import queue
        import threading

        self.pairs = pairs
        self.batch = batch
        self.device = device
        self.remainder: list = []
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.t = threading.Thread(target=self._worker, daemon=True)
        self.t.start()

    @staticmethod
    def _load(item):
        a, b = item
        if isinstance(a, str):
            a, b = read_grayscale(a), read_grayscale(b)
        return (np.clip(a, 0, 255).astype(np.uint8), np.clip(b, 0, 255).astype(np.uint8))

    def _worker(self):
        import torch

        buf_l, buf_r = [], []
        try:
            for item in self.pairs:
                il, ir = self._load(item)
                buf_l.append(il)
                buf_r.append(ir)
                if len(buf_l) == self.batch:
                    dl = torch.from_numpy(np.stack(buf_l)).to(self.device)
                    dr = torch.from_numpy(np.stack(buf_r)).to(self.device)
                    buf_l, buf_r = [], []
                    self.q.put((dl, dr))
            self.remainder = list(zip(buf_l, buf_r))
            self.q.put(None)
        except BaseException as e:  # re-raised by the consuming thread
            self.q.put(e)

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
