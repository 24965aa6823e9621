"""The port's entry point, ``python -m direct_stereo_slam_tpu_torch.run_slam``,
on the CPU: a short synthetic run writes sodso.txt and dslam.txt in the
``incoming_id x y z`` format and prints ``loop_count``, synchronous and
pipelined (``--pipelined``); each of the options a later slice ported
runs and writes what it should: ``--bag`` (a trajectory row per keyframe
as the same frames from memory), ``--ros-master`` (live topics),
``--live`` (live.html), ``--debug-dir`` (the PNGs), ``--step`` (one
prompt per frame, on a patched stdin) and ``--plot`` (trajectory.png;
without matplotlib the run stops before any work). Image folders
(``--dir0/--dir1``) are run in test_torch_undistort.py, the live CLI as
a process in test_torch_ros_transport.py."""

import io
import json
import re
import threading
import time

import cv2
import numpy as np
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


def _rows(out, name="sodso.txt"):
    return [line.split() for line in (out / name).read_text().strip().splitlines()]


def _raw_frames(tmp_path, n=14):
    """The synthetic run's frames as a camera gives them (uint8), and the
    raw-image path's flags: a pinhole camera file and the stereo
    extrinsics."""
    from direct_stereo_slam_tpu_torch.io.synthetic import SyntheticStereoDataset

    ds = SyntheticStereoDataset(n_frames=n, width=96, height=48, device="cpu")
    K = ds.K
    calib, stereo = tmp_path / "cam.txt", tmp_path / "T_stereo.yaml"
    calib.write_text(f"Pinhole {K[0,0]} {K[1,1]} {K[0,2]} {K[1,2]} 0\n96 48\nfull\n96 48\n")
    stereo.write_text("T_stereo: !!opencv-matrix\n  rows: 4\n  cols: 4\n  dt: d\n  data: ["
                      + ", ".join(repr(float(x)) for x in ds.t_cam1_cam0.reshape(-1)) + "]\n")
    frames = [ds.frame(i) for i in range(n)]
    u8 = [tuple(np.clip(np.asarray(f[k]), 0, 255).astype(np.uint8) for k in ("img0", "img1"))
          + (float(f["timestamp"]),) for f in frames]
    return u8, ["--calib0", str(calib), "--t-stereo", str(stereo)]


def _raw_run(out, calib, *flags):
    return run_slam.main([*calib, "--levels", "3", "--loop-margin", "2",
                          "--device", "cpu", "--out", str(out), *flags])


def _option_bag(tmp_path, capsys):
    from direct_stereo_slam_tpu_torch.io.rosbag import write_stereo_bag

    frames, calib = _raw_frames(tmp_path)
    msgs = [m for a, b, t in frames for m in (("/cam0/image_raw", t, a), ("/cam1/image_raw", t, b))]
    write_stereo_bag(str(tmp_path / "seq.bag"), msgs, compression="bz2")
    assert _raw_run(tmp_path / "out", calib, "--bag", str(tmp_path / "seq.bag")) == 0
    assert "14 stereo pairs replayed" in capsys.readouterr().out
    rows = _rows(tmp_path / "out")
    assert len(rows) >= 1 and all(len(r) == 4 for r in rows)
    # the same frames from an image folder give the same keyframe rows
    for side, i in (("l", 0), ("r", 1)):
        (tmp_path / side).mkdir()
        for j, f in enumerate(frames):
            cv2.imwrite(str(tmp_path / side / f"{j:06d}.png"), f[i])
    assert _raw_run(tmp_path / "dir", calib, "--dir0", str(tmp_path / "l"),
                    "--dir1", str(tmp_path / "r")) == 0
    assert [r[0] for r in rows] == [r[0] for r in _rows(tmp_path / "dir")]


def _option_ros_master(tmp_path, capsys):
    from direct_stereo_slam_tpu_torch.io.ros_transport import ImagePublisher, MiniMaster

    frames, calib = _raw_frames(tmp_path, 8)
    master = MiniMaster()
    pubs = [ImagePublisher(f"/cam{i}/image_raw", master.uri, f"/p{i}") for i in (0, 1)]

    def publish():
        deadline = time.time() + 60
        while not all(p.connected for p in pubs) and time.time() < deadline:
            time.sleep(0.02)
        for a, b, t in frames:
            pubs[0].publish(a, t)
            pubs[1].publish(b, t)
            time.sleep(0.01)

    feeder = threading.Thread(target=publish)
    feeder.start()
    try:
        rc = _raw_run(tmp_path / "out", calib, "--ros-master", master.uri,
                      "--ros-idle", "2")
    finally:
        feeder.join(timeout=70)
        for p in pubs:
            p.close()
        master.close()
    assert rc == 0 and not feeder.is_alive()
    printed = capsys.readouterr().out
    assert "8 stereo pairs received" in printed
    assert re.search(r"per_frame: [\d.]+ms x 8\b", printed)
    assert (tmp_path / "out" / "sodso.txt").exists()


def _option_live(tmp_path, capsys):
    assert _synthetic_run(tmp_path / "out", "--live") == 0
    page = (tmp_path / "out" / "live.html").read_text()
    state = json.loads(re.search(r"const S = (\{.*?\});\n", page, re.S).group(1))
    assert len(state["trail"]) == 13 and state["kfs"] and state["depth_png"]


def _option_debug_dir(tmp_path, capsys):
    assert _synthetic_run(tmp_path / "out", "--debug-dir", str(tmp_path / "dbg")) == 0
    names = sorted(p.name for p in (tmp_path / "dbg").iterdir())
    for kind in ("_idepth.png", "_window.png", "_residual.png"):
        assert any(n.endswith(kind) for n in names), (kind, names)
    assert all(cv2.imread(str(tmp_path / "dbg" / n)) is not None for n in names)


def _option_step(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr("sys.stdin", io.StringIO("\n" * 14))
    assert _synthetic_run(tmp_path / "out", "--step") == 0
    prompts = re.findall(r"\[step\] frame (\d+) kf=", capsys.readouterr().out)
    assert prompts == [str(i) for i in range(14)]


def _option_plot(tmp_path, capsys):
    assert _synthetic_run(tmp_path / "out", "--plot") == 0
    img = cv2.imread(str(tmp_path / "out" / "trajectory.png"))
    assert img is not None and img.shape[0] > 100


@pytest.mark.parametrize("option", ["bag", "ros-master", "live", "debug-dir", "step",
                                    "plot"])
def test_ported_option_runs(tmp_path, capsys, monkeypatch, option):
    _small_config(monkeypatch)
    run = {"bag": _option_bag, "ros-master": _option_ros_master, "live": _option_live,
           "debug-dir": _option_debug_dir, "plot": _option_plot}
    if option == "step":
        _option_step(tmp_path, capsys, monkeypatch)
    else:
        run[option](tmp_path, capsys)


def test_plot_without_matplotlib_stops_before_any_work(tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)       # import fails
    with pytest.raises(SystemExit, match="matplotlib"):
        _synthetic_run(tmp_path / "out", "--plot")
    assert not (tmp_path / "out").exists()
