"""The port's `io/` against the JAX package's, on the same inputs (the
cases of tests/test_io.py and tests/test_native_image.py, run through both
packages).

- Dataset listings (KITTI, EuRoC with an unpaired timestamp, suffix-paired
  "other") identical, and the same errors for an unknown dataset and a
  KITTI count mismatch.
- Both calibration formats, the reference's key=value file (rectified,
  with the `b` shorthand; and general, with distortion and extrinsics) and
  KITTI's calib.txt: every rig field equal (the same float32 NumPy
  construction in both), the same `rectified` flag.
- Exports: poses, points and constraints written by both are byte-identical
  and read back equal; the map and pose-graph PLYs (headers, the
  observation-count palette) and the pose-graph text dump byte-identical.
- Images: gray8, RGB and RGBA PNGs through both packages' native reader
  (the repository's `native/` library; skipped where it does not load),
  the grayscale dispatch, the missing file, and the prefetching readers
  (the same frames in the same order); the port's device batch reader
  (K-frame uint8 batches on the CPU, the remainder as host pairs) against
  the JAX package's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
Image = pytest.importorskip("PIL.Image")

from stereo_orb_slam_tpu.io import (  # noqa: E402
    calib as rcalib, datasets as rdatasets, export as rexport, native_image as rnative,
)
from stereo_orb_slam_torch.io import calib, datasets, export, native_image  # noqa: E402

torch.set_num_threads(1)


def _kitti(root):
    for cam in ("image_0", "image_1"):
        (root / cam).mkdir()
        for i in [2, 0, 1]:
            (root / cam / f"{i:06d}.png").write_bytes(b"")


def _euroc(root):
    for cam, extra in (("cam0", "102,c.png\n"), ("cam1", "103,c.png\n")):
        d = root / "mav0" / cam
        (d / "data").mkdir(parents=True)
        with open(d / "data.csv", "w") as f:
            f.write("#timestamp,filename\n100,a.png\n101,b.png\n" + extra)


def _other(root):
    for n in ["0l.png", "0r.png", "1l.png", "1r.png", "notes.txt"]:
        (root / n).write_bytes(b"")


@pytest.mark.parametrize("name,make,count", [("kitti", _kitti, 3), ("EuRoc", _euroc, 2),
                                             ("other", _other, 2)])
def test_listings_match_reference(tmp_path, name, make, count):
    make(tmp_path)
    got = datasets.load_dataset(name, str(tmp_path))
    assert got == rdatasets.load_dataset(name, str(tmp_path))
    assert len(got) == count


def test_listing_errors_match_reference(tmp_path):
    for mod in (datasets, rdatasets):
        with pytest.raises(ValueError, match="Unknown dataset 'tum'"):
            mod.load_dataset("tum", str(tmp_path))
    _kitti(tmp_path)
    (tmp_path / "image_1" / "000003.png").write_bytes(b"")
    for mod in (datasets, rdatasets):
        with pytest.raises(ValueError, match="count mismatch"):
            mod.load_dataset("kitti", str(tmp_path))


REFERENCE_RECTIFIED = (
    "type=StereoRectified\n"
    "fx_l=718.856\nfy_l=718.856\ncx_l=607.1928\ncy_l=185.2157\n"
    "fx_r=718.856\nfy_r=718.856\ncx_r=607.1928\ncy_r=185.2157\n"
    "b=0.5371657\n"
)
REFERENCE_GENERAL = (
    "type=Stereo\n"
    "fx_l=458.654\nfy_l=457.296\ncx_l=367.215\ncy_l=248.375\n"
    "d_l=-0.28340811 0.07395907 0.00019359 1.76187114e-05 0\n"
    "fx_r=457.587\nfy_r=456.134\ncx_r=379.999\ncy_r=255.238\n"
    "d_r=-0.28368365 0.07451284 -0.00010473 -3.55590700e-05 0\n"
    "T_l=1 0 0 0 0 1 0 0 0 0 1 0 0 0 0 1\n"
    "T_r=0.99999 -0.00223 -0.00043 0.11007 0.00223 0.99995 -0.00960 -0.00016 "
    "0.00045 0.00960 0.99995 0.00089 0 0 0 1\n"
)
FX, CX, CY, B = 718.856, 607.1928, 185.2157, 0.5371657
KITTI_CALIB = (f"P0: {FX} 0 {CX} 0 0 {FX} {CY} 0 0 0 1 0\n"
               f"P1: {FX} 0 {CX} {-FX * B} 0 {FX} {CY} 0 0 0 1 0\n")


@pytest.mark.parametrize("name,text,rectified", [
    ("camera.txt", REFERENCE_RECTIFIED, True), ("camera_euroc.txt", REFERENCE_GENERAL, False),
    ("calib.txt", KITTI_CALIB, True)])
def test_calibration_formats_match_reference(tmp_path, name, text, rectified):
    p = tmp_path / name
    p.write_text(text)
    rig = calib.load_camera(str(p), device="cpu")
    ref = rcalib.load_camera(str(p))
    assert rig.rectified is bool(ref.rectified) is rectified
    for side in ("left", "right"):
        for field in ("fx", "fy", "cx", "cy", "dist", "pose", "projection"):
            got = getattr(getattr(rig, side), field)
            assert got.dtype == torch.float32 and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(getattr(ref, side),
                                                                          field)))
    np.testing.assert_array_equal(rig.baseline.numpy(), np.asarray(ref.baseline))
    np.testing.assert_array_equal(rig.max_sensible_distance().numpy(),
                                  np.asarray(ref.max_sensible_distance()))


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def test_txt_exports_match_reference_and_round_trip(tmp_path, rng):
    poses = rng.normal(size=(5, 4, 4)).astype(np.float32)
    points = rng.normal(size=(7, 3)).astype(np.float32) * 10
    n = 20
    frame = rng.integers(0, 5, n).astype(np.int32)
    point = rng.integers(0, 100, n).astype(np.int32)
    uv = rng.normal(size=(n, 4)).astype(np.float32) * 100
    sigma = np.ones(n, np.float32)
    for mod, d in ((export, tmp_path / "port"), (rexport, tmp_path / "ref")):
        d.mkdir()
        mod.save_poses_txt(str(d / "poses.txt"), poses)
        mod.save_points_txt(str(d / "points.txt"), points)
        mod.save_constraints_txt(str(d / "constraints.txt"), frame, point, uv, sigma)
        mod.save_kitti_trajectory(str(d / "trajectory.txt"), poses)
    for name in ("poses.txt", "points.txt", "constraints.txt", "trajectory.txt"):
        assert _same_bytes(tmp_path / "port" / name, tmp_path / "ref" / name), name

    path = str(tmp_path / "port" / "poses.txt")
    back = export.read_poses_txt(path)
    np.testing.assert_array_equal(back, rexport.read_poses_txt(path))
    np.testing.assert_allclose(back, poses, rtol=1e-5)
    with open(path) as f:
        assert f.readline().strip() == "5"
    path = str(tmp_path / "port" / "points.txt")
    np.testing.assert_array_equal(export.read_points_txt(path), rexport.read_points_txt(path))
    path = str(tmp_path / "port" / "constraints.txt")
    got, want = export.read_constraints_txt(path), rexport.read_constraints_txt(path)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], frame)
    np.testing.assert_array_equal(got[1], point)
    np.testing.assert_allclose(got[2], uv, rtol=1e-4, atol=1e-3)


def test_ply_exports_match_reference(tmp_path, rng):
    poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    poses[:, 0, 3] = [0.0, 1.5, 3.0]
    pts = rng.normal(size=(4, 3)).astype(np.float32)
    for mod, d in ((export, tmp_path / "port"), (rexport, tmp_path / "ref")):
        d.mkdir()
        mod.save_map_ply(str(d / "map.ply"), poses, pts, [1, 3, 7, 20])
        mod.save_pose_graph_ply(str(d / "pg.ply"), poses, [(0, 2)])
        mod.save_poses_ply(str(d / "waypoints.ply"), poses)
        mod.save_pose_graph_txt(str(d / "pg.txt"), poses, [(0, 2)])
    for name in ("map.ply", "pg.ply", "waypoints.ply", "pg.txt"):
        assert _same_bytes(tmp_path / "port" / name, tmp_path / "ref" / name), name
    text = (tmp_path / "port" / "map.ply").read_text().splitlines()
    assert text[0] == "ply" and "element vertex 7" in text
    # the observation-count palette (ref ply_utils.h:144-167)
    assert [line.split()[-3:] for line in text[-4:]] == [
        ["255", "255", "255"], ["255", "255", "0"], ["255", "172", "28"], ["204", "85", "0"]]
    lines = (tmp_path / "port" / "pg.ply").read_text().splitlines()
    assert "element edge 1" in lines and lines[-1] == "0 2 255 0 0"


def _png(tmp_path, arr, mode):
    p = str(tmp_path / f"img_{mode}.png")
    Image.fromarray(arr, mode=mode).save(p)
    return p


@pytest.mark.parametrize("mode,shape,skew", [("L", (48, 64), 0.0), ("RGB", (32, 40, 3), 1.0),
                                             ("RGBA", (16, 20, 4), 1.0)])
def test_native_reader_matches_reference(tmp_path, rng, mode, shape, skew):
    p = _png(tmp_path, rng.integers(0, 256, shape, dtype=np.uint8), mode)
    ours = native_image.read_png_gray(p)
    if ours is None:
        pytest.skip("the native PNG library does not load here")
    np.testing.assert_array_equal(ours, rnative.read_png_gray(p))
    with Image.open(p) as im:
        pil = np.asarray(im.convert("L"), dtype=np.float32)
    # PIL uses the same BT.601 integer weights; 1-count rounding skew.
    assert np.abs(ours - pil).max() <= skew


def test_grayscale_dispatch_and_missing_file_match_reference(tmp_path, rng):
    arr = rng.integers(0, 256, (24, 24), dtype=np.uint8)
    p = _png(tmp_path, arr, "L")
    img = datasets.read_grayscale(p)
    assert img.dtype == np.float32
    np.testing.assert_array_equal(img, arr.astype(np.float32))
    np.testing.assert_array_equal(img, rdatasets.read_grayscale(p))
    assert native_image.read_png_gray("/nonexistent/file.png") is None
    assert rnative.read_png_gray("/nonexistent/file.png") is None


def _pairs(tmp_path, rng, n):
    paths = []
    for i in range(n):
        for side in "lr":
            arr = rng.integers(0, 256, (16, 16), dtype=np.uint8)
            Image.fromarray(arr, mode="L").save(str(tmp_path / f"{i}{side}.png"))
        paths.append((str(tmp_path / f"{i}l.png"), str(tmp_path / f"{i}r.png")))
    return paths


def test_prefetching_readers_match_reference(tmp_path, rng):
    paths = _pairs(tmp_path, rng, 5)
    got = list(datasets.PrefetchingReader(paths, depth=2))
    want = list(rdatasets.PrefetchingReader(paths, depth=2))
    assert len(got) == len(want) == 5 and got[0][0].shape == (16, 16)
    for (gl, gr), (wl, wr) in zip(got, want):
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(gr, wr)

    import jax

    reader = datasets.DeviceBatchReader(paths, batch=2, device="cpu")
    batches = list(reader)
    ref = rdatasets.DeviceBatchReader(paths, batch=2, device=jax.devices("cpu")[0])
    ref_batches = list(ref)
    assert len(batches) == len(ref_batches) == 2
    for (gl, gr), (wl, wr) in zip(batches, ref_batches):
        assert gl.dtype == torch.uint8 and gl.shape == (2, 16, 16) and gl.device.type == "cpu"
        np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
        np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
    assert len(reader.remainder) == len(ref.remainder) == 1
    for g, w in zip(reader.remainder[0], ref.remainder[0]):
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)
