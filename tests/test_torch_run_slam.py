"""The port's entry point, ``python -m direct_stereo_slam_tpu_torch.run_slam``,
on the CPU: a short synthetic run writes sodso.txt and dslam.txt in the
``incoming_id x y z`` format and prints ``loop_count``, synchronous and
pipelined (``--pipelined``); the options not ported yet (rosbag, ROS
topics, the plot, the viewer, debug dumps, step mode) raise
``NotImplementedError`` before any work starts. Image folders
(``--dir0/--dir1``) are run in test_torch_undistort.py."""

import pytest

from direct_stereo_slam_tpu_torch import config, run_slam
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def _small_config(monkeypatch):
    """The smoke size of test_torch_slice_e2e.py: a window of 4 keyframes
    with small point budgets, so keyframes leave the window early."""
    make = config.make_config

    def small_config(*a, **kw):
        cfg = make(*a, **kw)
        return cfg.replace(ba=cfg.ba.__class__(
            max_frames=4, min_frames=3, max_points_per_frame=64,
            max_immature_per_frame=128, desired_point_density=150.0,
            desired_immature_density=100.0))

    monkeypatch.setattr(config, "make_config", small_config)


def _synthetic_run(out, *flags):
    return run_slam.main(["--synthetic", "--frames", "14", "--width", "96",
                          "--height", "48", "--loop-margin", "2", "--device", "cpu",
                          "--out", str(out), *flags])


def test_synthetic_run_writes_trajectories(tmp_path, capsys, monkeypatch):
    _small_config(monkeypatch)
    out = tmp_path / "out"
    rc = _synthetic_run(out)
    assert rc == 0
    printed = capsys.readouterr().out
    assert "loop_count:" in printed and "ATE sodso" in printed
    sodso = (out / "sodso.txt").read_text().strip().splitlines()
    dslam = (out / "dslam.txt").read_text().strip().splitlines()
    assert len(sodso) == len(dslam) >= 1
    assert all(len(line.split()) == 4 for line in sodso + dslam)


def test_pipelined_run_writes_the_same_keyframe_rows(tmp_path, monkeypatch):
    """--pipelined: every frame is consumed by the end of the run (the
    in-flight one by finish), and the odometry has a row per keyframe
    that left the window, as in the synchronous run."""
    _small_config(monkeypatch)
    rows = {}
    for mode, flags in (("sync", ()), ("pipelined", ("--pipelined",))):
        out = tmp_path / mode
        assert _synthetic_run(out, *flags) == 0
        rows[mode] = [line.split() for line in
                      (out / "sodso.txt").read_text().strip().splitlines()]
    assert [r[0] for r in rows["pipelined"]] == [r[0] for r in rows["sync"]]
    for a, b in zip(rows["sync"], rows["pipelined"]):
        assert max(abs(float(x) - float(y)) for x, y in zip(a[1:], b[1:])) < 0.05


@pytest.mark.parametrize("flags", [["--bag", "x.bag"], ["--ros-master", "http://h:1"],
                                   ["--plot"], ["--live"], ["--debug-dir", "dumps"],
                                   ["--step"]])
def test_unported_options_raise(tmp_path, flags):
    with pytest.raises(NotImplementedError):
        run_slam.main(["--synthetic", "--device", "cpu", "--out", str(tmp_path)] + flags)
    assert not any(tmp_path.iterdir())
