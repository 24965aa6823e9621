"""The port's entry scripts against the JAX package's, on the CPU: each
JAX script runs as a process (``JAX_PLATFORMS=cpu``) while the port's runs
in this one with ``--device cpu``.

- ``gen_longseq`` at 96x48, 6 frames: ``calib.txt``, ``times.txt`` and
  the poses byte for byte, every PNG within 1 gray level (the renderers'
  floats differ in the last bits, which may move a pixel across an
  integer);
- ``eval_kitti --config odometry --levels 3`` over one written layout
  (16 frames: the first keyframes leave the window, so sodso has rows):
  the same keyframe count and ATE within 1e-2 m, and ``results.json`` and
  ``results.md`` with the JAX script's fields and table;
- ``run_batch`` at 64x32, 2 levels, 3 sequences, 4 frames: the median
  translation error within 1e-3 m (the scripts print it in cm to 2
  decimals) and the same median rotation error.
"""

import json
import os
import re
import subprocess
import sys

import cv2
import numpy as np
import pytest

from direct_stereo_slam_tpu_torch import eval_kitti, gen_longseq, run_batch
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script(name, *args):
    """A JAX package script started as a process on the CPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, os.path.join(REPO, "scripts", name), *args],
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _done(proc, timeout=600):
    out, _ = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, out[-3000:]
    return out


def test_gen_longseq_matches(tmp_path):
    size = ["--frames", "6", "--width", "96", "--height", "48"]
    proc = _jax_script("gen_longseq.py", "--out", str(tmp_path / "jax"), *size)
    assert gen_longseq.main(["--out", str(tmp_path / "port"), *size, "--device", "cpu"]) == 0
    _done(proc)
    for rel in ("sequences/00/calib.txt", "sequences/00/times.txt", "poses/00.txt"):
        assert (tmp_path / "port" / rel).read_text() == (tmp_path / "jax" / rel).read_text()
    for cam in ("image_0", "image_1"):
        names = sorted(os.listdir(tmp_path / "jax" / "sequences" / "00" / cam))
        assert names == sorted(os.listdir(tmp_path / "port" / "sequences" / "00" / cam))
        assert len(names) == 6
        for n in names:
            a, b = (cv2.imread(str(tmp_path / k / "sequences" / "00" / cam / n),
                               cv2.IMREAD_UNCHANGED) for k in ("jax", "port"))
            assert a.shape == b.shape == (48, 96) and a.dtype == b.dtype == np.uint8
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, (cam, n)


def test_eval_kitti_matches(tmp_path):
    root = str(tmp_path / "kitti")
    assert gen_longseq.main(["--out", root, "--frames", "16", "--width", "96",
                             "--height", "48", "--device", "cpu"]) == 0
    run = ["--kitti", root, "--seqs", "00", "--config", "odometry", "--levels", "3"]
    proc = _jax_script("eval_kitti.py", *run, "--cpu", "--out", str(tmp_path / "jax"))
    assert eval_kitti.main([*run, "--device", "cpu", "--out", str(tmp_path / "port")]) == 0
    _done(proc)
    rows = {}
    for k in ("jax", "port"):
        with open(tmp_path / k / "results.json") as f:
            rows[k] = json.load(f)
        assert len(rows[k]) == 1
        assert os.path.exists(tmp_path / k / "00_odometry" / "sodso.txt")
    want, got = rows["jax"][0], rows["port"][0]
    assert sorted(got) == sorted(want)
    assert (got["seq"], got["config"], got["frames"]) == ("00", "odometry", 16)
    assert got["kfs"] == want["kfs"] >= 3
    assert got["ate_sodso"] is not None and want["ate_sodso"] is not None
    assert abs(got["ate_sodso"] - want["ate_sodso"]) <= 1e-2
    head = lambda k: (tmp_path / k / "results.md").read_text().splitlines()[:2]
    assert head("port") == head("jax")


def _medians(text):
    m = re.search(r"median \|t\| ([0-9.]+) cm, median \|w\| ([0-9.]+) deg", text)
    assert m, text[-2000:]
    return float(m.group(1)) / 100.0, float(m.group(2))


def test_run_batch_matches(capsys):
    size = ["--sequences", "3", "--frames", "4", "--width", "64", "--height", "32",
            "--levels", "2"]
    proc = _jax_script("run_batch.py", *size, "--cpu", "--devices", "1")
    assert run_batch.main([*size, "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    want = _done(proc)
    assert "devices 1  sequences 3  frames 4" in got
    t_got, w_got = _medians(got)
    t_want, w_want = _medians(want)
    assert abs(t_got - t_want) <= 1e-3 and w_got == pytest.approx(w_want, abs=2e-3)


def test_run_batch_passes_restep_the_same_inputs():
    """More passes step through the same inputs again: the first pass's
    poses and errors are those of a single pass, every step is timed once
    per pass (the very first untimed), and each pass has its FPS."""
    size = dict(sequences=2, frames=3, width=64, height=32, levels=2, device="cpu")
    one = run_batch.run(**size)
    three = run_batch.run(**size, passes=3)
    np.testing.assert_array_equal(three["T"], one["T"])
    assert three["errs_t"] == one["errs_t"] and three["errs_r"] == one["errs_r"]
    assert len(three["step_s"]) == 3 * 2 and len(three["pass_fps"]) == 3
    assert three["seconds"] == pytest.approx(sum(three["step_s"][1:]))
    assert three["fps"] == pytest.approx(5 * 2 / three["seconds"])
