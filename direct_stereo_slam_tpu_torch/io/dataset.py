"""Dataset readers (the port's copy of the JAX package's
``io/dataset.py``, pinned to it by ``tests/test_torch_host_copies.py``).

The reference ingests stereo pairs from rosbags or live ROS topics
(main.cpp:310-363); outside ROS the equivalent sources are:

* ``KittiOdometryDataset`` — the KITTI odometry folder layout
  (``sequences/NN/{image_0,image_1}/*.png`` + ``times.txt`` + ``calib.txt``),
  the dataset behind the reference's primary benchmarks (BASELINE.json
  configs 1/3/5);
* ``StereoDirDataset`` — two directories of time-sorted images + optional
  timestamp file (Malaga / RobotCar exports);
* ``UnsyncedStereoDataset`` — two INDEPENDENTLY timestamped streams
  paired by approximate-time sync (io.sync) — the bag-replay / live-topic
  ingestion model of the reference (main.cpp:320-345, 355-362);
* ``SyntheticStereoDataset`` (io.synthetic) — ground-truth test bed.

Decoding uses the port's native loader for PGM/PPM (io.native, colour
channels averaged, as the JAX package reads them) and cv2 (PIL where cv2
is missing) for PNG/JPG. A native library that cannot be built raises:
cv2 reads a PPM or a 16-bit PGM into other gray levels. Each dataset
yields dicts with ``img0``, ``img1`` (float32 HxW), ``timestamp`` and
``incoming_id`` — the SLAMNode input contract.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional

import numpy as np


def _imread_gray(path: str) -> np.ndarray:
    ext = os.path.splitext(path)[1].lower()
    if ext in (".pgm", ".ppm", ".pnm"):
        from .native import read_pnm
        img = read_pnm(path)
        if img.ndim == 3:
            img = img.mean(axis=2)
        return img.astype(np.float32)
    try:
        import cv2
        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise IOError(path)
        return img.astype(np.float32)
    except ImportError:
        from PIL import Image
        return np.asarray(Image.open(path).convert("L"), dtype=np.float32)


class StereoDirDataset:
    """Two directories of synchronized, name-sorted stereo images."""

    def __init__(self, dir0: str, dir1: str, timestamps: Optional[str] = None,
                 fps: float = 10.0, pattern: str = "*"):
        self.files0 = sorted(glob.glob(os.path.join(dir0, pattern)))
        self.files1 = sorted(glob.glob(os.path.join(dir1, pattern)))
        n = min(len(self.files0), len(self.files1))
        self.files0, self.files1 = self.files0[:n], self.files1[:n]
        self.exposures = [1.0] * n
        if timestamps and os.path.exists(timestamps):
            # per-LINE parse: 1 column = time; 2 = time exposure;
            # 3 = id time exposure (the TUM-monoVO times.txt format DSO's
            # ImageFolderReader consumes — exposure in ms)
            times, exps = [], []
            with open(timestamps) as f:
                for line in f:
                    cols = line.split()
                    if not cols:
                        continue
                    if len(cols) == 1:
                        times.append(float(cols[0])); exps.append(1.0)
                    elif len(cols) == 2:
                        times.append(float(cols[0])); exps.append(float(cols[1]))
                    else:
                        times.append(float(cols[1])); exps.append(float(cols[2]))
            self.times = times[:n]
            exps = (exps + [1.0] * n)[:n]
            # repair unrecorded (0) exposures by neighbor interpolation,
            # as DSO's ImageFolderReader does for TUM-monoVO times files
            arr = np.asarray(exps, np.float64)
            bad = arr <= 0
            if bad.any() and not bad.all():
                good_idx = np.nonzero(~bad)[0]
                arr[bad] = np.interp(np.nonzero(bad)[0], good_idx,
                                     arr[good_idx])
            elif bad.all():
                arr[:] = 1.0
            self.exposures = arr.tolist()
        else:
            self.times = [i / fps for i in range(n)]

    def __len__(self):
        return len(self.files0)

    def frame(self, i: int):
        return {
            "img0": _imread_gray(self.files0[i]),
            "img1": _imread_gray(self.files1[i]),
            "timestamp": self.times[i],
            "incoming_id": i,
            "exposure": self.exposures[i],
        }

    def __iter__(self):
        for i in range(len(self)):
            yield self.frame(i)


class UnsyncedStereoDataset:
    """Bag-like replay of two independently-timestamped image streams.

    Each stream is a directory plus a timestamp file (one stamp per
    sorted image, seconds). Pairs are formed by
    :class:`.sync.ApproximateTimeSync` with the
    given ``slop`` — frames with no partner within slop are dropped
    (observable via ``dropped``), exactly the behavior of the reference's
    ``message_filters::ApproximateTime`` callback path. The emitted
    timestamp is the left-camera stamp."""

    def __init__(self, dir0: str, dir1: str, times0: str, times1: str,
                 slop: float = 0.01, queue_size: int = 10, pattern: str = "*"):
        from .sync import ApproximateTimeSync, replay

        files0 = sorted(glob.glob(os.path.join(dir0, pattern)))
        files1 = sorted(glob.glob(os.path.join(dir1, pattern)))

        def load_times(path, n):
            with open(path) as f:
                ts = [float(x) for x in f.read().split()]
            if len(ts) < n:
                raise ValueError(f"{path}: {len(ts)} stamps for {n} images")
            return ts[:n]

        t0 = load_times(times0, len(files0))
        t1 = load_times(times1, len(files1))
        self.pairs = list(replay(
            [list(zip(t0, files0)), list(zip(t1, files1))],
            slop, queue_size))
        self.dropped = (len(files0) + len(files1)) - 2 * len(self.pairs)

    def __len__(self):
        return len(self.pairs)

    def frame(self, i: int):
        ta, f0, tb, f1 = self.pairs[i]
        return {
            "img0": _imread_gray(f0),
            "img1": _imread_gray(f1),
            "timestamp": ta,
            "incoming_id": i,
        }

    def __iter__(self):
        for i in range(len(self)):
            yield self.frame(i)


class KittiOdometryDataset(StereoDirDataset):
    """KITTI odometry sequence folder: ``<root>/sequences/<seq>/``."""

    def __init__(self, root: str, sequence: str = "00"):
        seq_dir = os.path.join(root, "sequences", sequence)
        super().__init__(
            os.path.join(seq_dir, "image_0"),
            os.path.join(seq_dir, "image_1"),
            timestamps=os.path.join(seq_dir, "times.txt"),
            pattern="*.png",
        )
        self.calib = self._parse_calib(os.path.join(seq_dir, "calib.txt"))

    @staticmethod
    def _parse_calib(path: str):
        """Returns dict with fx fy cx cy and the stereo baseline (meters).
        KITTI calib.txt stores P0/P1 3x4 projection matrices; baseline =
        -P1[0,3]/fx."""
        out = {}
        if not os.path.exists(path):
            return out
        with open(path) as f:
            for line in f:
                if ":" not in line:
                    continue
                key, vals = line.split(":", 1)
                out[key.strip()] = np.array(
                    [float(x) for x in vals.split()]).reshape(3, 4)
        if "P0" in out and "P1" in out:
            P0, P1 = out["P0"], out["P1"]
            out["fx"], out["fy"] = P0[0, 0], P0[1, 1]
            out["cx"], out["cy"] = P0[0, 2], P0[1, 2]
            out["baseline"] = -P1[0, 3] / P1[0, 0]
        return out

    def t_cam1_cam0(self) -> np.ndarray:
        """Pose of cam0 in cam1 (the reference's T_stereo convention,
        cams/kitti/*/T_stereo.yaml)."""
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = -float(self.calib.get("baseline", 0.5372))
        T[2, 3] = 1e-9   # reference numerical-stability quirk (README.md:58)
        return T
