"""The port's entry point, ``python -m direct_stereo_slam_tpu_torch.run_slam``,
on the CPU: a short synthetic run writes sodso.txt and dslam.txt in the
``incoming_id x y z`` format and prints ``loop_count``; the options not
ported yet raise ``NotImplementedError`` before any work starts."""

import pytest

from direct_stereo_slam_tpu_torch import config, run_slam
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def test_synthetic_run_writes_trajectories(tmp_path, capsys, monkeypatch):
    # the smoke size of test_torch_slice_e2e.py: a window of 4 keyframes
    # with small point budgets, so keyframes leave the window early
    make = config.make_config

    def small_config(*a, **kw):
        cfg = make(*a, **kw)
        return cfg.replace(ba=cfg.ba.__class__(
            max_frames=4, min_frames=3, max_points_per_frame=64,
            max_immature_per_frame=128, desired_point_density=150.0,
            desired_immature_density=100.0))

    monkeypatch.setattr(config, "make_config", small_config)
    out = tmp_path / "out"
    rc = run_slam.main(["--synthetic", "--frames", "14", "--width", "96",
                        "--height", "48", "--loop-margin", "2", "--device", "cpu",
                        "--out", str(out)])
    assert rc == 0
    printed = capsys.readouterr().out
    assert "loop_count:" in printed and "ATE sodso" in printed
    sodso = (out / "sodso.txt").read_text().strip().splitlines()
    dslam = (out / "dslam.txt").read_text().strip().splitlines()
    assert len(sodso) == len(dslam) >= 1
    assert all(len(line.split()) == 4 for line in sodso + dslam)


@pytest.mark.parametrize("flags", [["--bag", "x.bag"], ["--ros-master", "http://h:1"],
                                   ["--dir0", "a", "--dir1", "b"], ["--plot"],
                                   ["--pipelined"]])
def test_unported_options_raise(tmp_path, flags):
    with pytest.raises(NotImplementedError):
        run_slam.main(["--synthetic", "--device", "cpu", "--out", str(tmp_path)] + flags)
    assert not any(tmp_path.iterdir())
