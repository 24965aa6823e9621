"""The port's entry points run on the CUDA card unless the caller names
the CPU. On a host without a card, ``SLAMNode``, ``FrontEnd``,
``LoopHandler`` and ``runtime.eval.run_sequence`` called without a
``device`` raise, ``run_slam``, ``run_batch``, ``gen_longseq`` and
``eval_kitti`` without ``--device`` exit non-zero with a message, and
``make_mesh`` without a device raises; nothing carries on with the CPU in
the card's place. ``make_batched_step`` on CPU tensors takes the plain
per-sequence loop (no kernel launch counted).
(Where a card is present these tests have nothing to show and skip.)"""

import numpy as np
import pytest
import torch

from direct_stereo_slam_tpu_torch import eval_kitti, gen_longseq, run_batch, run_slam
from direct_stereo_slam_tpu_torch.config import make_config
from direct_stereo_slam_tpu_torch.geometry.camera import make_pyramid_intrinsics
from direct_stereo_slam_tpu_torch.loop.handler import LoopHandler
from direct_stereo_slam_tpu_torch.models.frontend import FrontEnd
from direct_stereo_slam_tpu_torch.runtime import eval as eval_t
from direct_stereo_slam_tpu_torch.runtime.node import SLAMNode
from direct_stereo_slam_tpu_torch.utils.device import resolve_device

pytestmark = pytest.mark.smoke

W, H = 96, 48


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs")


def _setup():
    cfg = make_config(W, H)
    intr = make_pyramid_intrinsics(80.0, 80.0, W / 2, H / 2, W, H, 3)
    t10 = np.eye(4, dtype=np.float32)
    t10[0, 3] = -0.54
    return cfg, intr, t10


def test_resolve_device(no_card):
    assert resolve_device("cpu") == torch.device("cpu")
    for dev in ("cuda", "cuda:0", torch.device("cuda")):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            resolve_device(dev)
    with pytest.raises(RuntimeError):
        resolve_device()


@pytest.mark.parametrize("entry", ["SLAMNode", "FrontEnd", "LoopHandler"])
def test_entry_points_default_to_the_card(no_card, entry):
    cfg, intr, t10 = _setup()
    make = {"SLAMNode": lambda **kw: SLAMNode(cfg, intr, intr, t10, **kw),
            "FrontEnd": lambda **kw: FrontEnd(cfg, intr, intr, t10, **kw),
            "LoopHandler": lambda **kw: LoopHandler(cfg, intr, threaded=False, **kw)}[entry]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make()
    obj = make(device="cpu")
    assert obj.device == torch.device("cpu")


def test_run_sequence_defaults_to_the_card(no_card):
    cfg, intr, t10 = _setup()

    class OneFrame:
        def __len__(self):
            return 1

        def frame(self, i):
            img = np.zeros((H, W), np.float32)
            return {"img0": img, "img1": img, "timestamp": 0.0}

    K = np.array([[80.0, 0, W / 2], [0, 80.0, H / 2], [0, 0, 1]])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        eval_t.run_sequence(OneFrame(), cfg, K, t10, levels=3)


def test_run_slam_without_device_exits_nonzero(no_card, tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        run_slam.main(["--synthetic", "--frames", "2", "--width", str(W),
                       "--height", str(H), "--out", str(tmp_path / "out")])
    assert exc.value.code not in (0, None)
    assert "no CUDA card" in str(exc.value.code)
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("cli", ["run_batch", "gen_longseq", "eval_kitti"])
def test_new_clis_without_device_exit_nonzero(no_card, tmp_path, cli):
    out = str(tmp_path / "out")
    argv = {"run_batch": ["--sequences", "1", "--frames", "2", "--width", str(W),
                          "--height", str(H), "--levels", "2"],
            "gen_longseq": ["--out", out, "--frames", "2", "--width", str(W),
                            "--height", str(H)],
            "eval_kitti": ["--kitti", out, "--seqs", "00", "--out", out]}[cli]
    main = {"run_batch": run_batch, "gen_longseq": gen_longseq, "eval_kitti": eval_kitti}[cli]
    with pytest.raises(SystemExit) as exc:
        main.main(argv)
    assert exc.value.code not in (0, None)
    assert "no CUDA card" in str(exc.value.code)
    assert not (tmp_path / "out").exists()


def test_mesh_defaults_to_the_card(no_card):
    from direct_stereo_slam_tpu_torch.parallel import mesh

    with pytest.raises(RuntimeError, match="no CUDA card"):
        mesh.make_mesh()
    assert mesh.make_mesh(2, device="cpu").devices == (torch.device("cpu"),) * 2


def test_batched_step_on_cpu_tensors_takes_the_plain_loop():
    from direct_stereo_slam_tpu_torch.models.depth_template import TrackerTemplate
    from direct_stereo_slam_tpu_torch.ops import resident_lm as rlm
    from direct_stereo_slam_tpu_torch.parallel import mesh

    cfg, intr, _ = _setup()
    cfg = cfg.replace(tracker=cfg.tracker.__class__(pyr_levels=3, max_iterations=(2, 2, 2)))
    rng = np.random.RandomState(0)
    S, n = 2, 64
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    tmpl = TrackerTemplate(
        pu=tuple(t(rng.uniform(3, (W >> l) - 4, (S, n))) for l in range(3)),
        pv=tuple(t(rng.uniform(3, (H >> l) - 4, (S, n))) for l in range(3)),
        pid=tuple(t(rng.uniform(0.1, 1.0, (S, n))) for l in range(3)),
        pcolor=tuple(t(rng.uniform(0, 255, (S, n))) for l in range(3)),
        pmask=tuple(torch.ones(S, n, dtype=torch.bool) for l in range(3)))
    imgs = t(rng.rand(S, H, W) * 255)
    counts = (rlm.track_lm_cuda.launches, rlm.scale_lm_cuda.launches)
    out = mesh.make_batched_step(intr, cfg, 3)(imgs, imgs, tmpl, torch.eye(4).expand(S, 4, 4))
    assert counts == (rlm.track_lm_cuda.launches, rlm.scale_lm_cuda.launches)
    assert out.T.shape == (S, 4, 4) and out.T.device.type == "cpu"
    assert bool(torch.isfinite(out.T).all())
