"""The port stands alone: importing its SLAMNode (the whole device path),
the loop-closure modules, the evaluation harness, the host modules it
keeps its own copies of, the monocular bootstrap, the undistorter, the
ROS input, checkpointing, the viewer and debug images, the batch
evaluation (``parallel/``), the native loader (``io/native``) and the
entry points ``run_slam``, ``run_batch``, ``gen_longseq`` and
``eval_kitti`` loads neither
``jax`` nor any module of the JAX package ``direct_stereo_slam_tpu``, no
source of the port imports either, and the device path turns TF32 off
(the reference pins full-f32 matmuls)."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

pytestmark = pytest.mark.smoke

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "direct_stereo_slam_tpu_torch"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import direct_stereo_slam_tpu_torch.runtime.node\n"
        "import direct_stereo_slam_tpu_torch.utils.convert\n"
        "import direct_stereo_slam_tpu_torch.loop.handler\n"
        "import direct_stereo_slam_tpu_torch.loop.pose_estimator\n"
        "import direct_stereo_slam_tpu_torch.loop.pose_graph\n"
        "import direct_stereo_slam_tpu_torch.loop.retrieval\n"
        "import direct_stereo_slam_tpu_torch.loop.scan\n"
        "import direct_stereo_slam_tpu_torch.loop.scancontext\n"
        "import direct_stereo_slam_tpu_torch.loop.icp\n"
        "import direct_stereo_slam_tpu_torch.runtime.eval\n"
        "import direct_stereo_slam_tpu_torch.run_slam\n"
        "import direct_stereo_slam_tpu_torch.config\n"
        "import direct_stereo_slam_tpu_torch.utils.calib\n"
        "import direct_stereo_slam_tpu_torch.io.dataset\n"
        "import direct_stereo_slam_tpu_torch.io.sync\n"
        "import direct_stereo_slam_tpu_torch.ops.resident_lm\n"
        "import direct_stereo_slam_tpu_torch.models.mono_init\n"
        "import direct_stereo_slam_tpu_torch.io.undistort\n"
        "import direct_stereo_slam_tpu_torch.io.rosbag\n"
        "import direct_stereo_slam_tpu_torch.io.ros_transport\n"
        "import direct_stereo_slam_tpu_torch.runtime.checkpoint\n"
        "import direct_stereo_slam_tpu_torch.viz.export\n"
        "import direct_stereo_slam_tpu_torch.viz.debug\n"
        "import direct_stereo_slam_tpu_torch.viz.live\n"
        "import direct_stereo_slam_tpu_torch.viz.png\n"
        "import direct_stereo_slam_tpu_torch.parallel.mesh\n"
        "import direct_stereo_slam_tpu_torch.io.native\n"
        "import direct_stereo_slam_tpu_torch.run_batch\n"
        "import direct_stereo_slam_tpu_torch.gen_longseq\n"
        "import direct_stereo_slam_tpu_torch.eval_kitti\n"
        "import torch\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'direct_stereo_slam_tpu'))\n"
        "assert not bad, bad\n"
        "assert torch.backends.cuda.matmul.allow_tf32 is False\n"
        "assert torch.backends.cudnn.allow_tf32 is False\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


@pytest.mark.parametrize("package", ["jax", "direct_stereo_slam_tpu"])
def test_no_port_source_imports(package):
    """No source of the port (nor chip_smoke.py) imports ``package``."""
    pattern = re.compile(rf"^\s*(import|from)\s+{package}(\.|\s|$)")
    offenders = []
    for path in [*PKG.rglob("*.py"), REPO / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            code = line.split("#")[0]
            if pattern.match(code) or re.search(rf"\bimport\s+{package}\b(?!_)", code):
                offenders.append(f"{path.relative_to(REPO)}: {line.strip()}")
    assert not offenders, offenders


def test_kernel_sources_present():
    names = {p.name for p in (PKG / "csrc").iterdir()}
    assert {"distance_map.cu", "residual_hb.cu", "resident_lm.cu", "pose_terms.cuh",
            "common.cuh", "native_io.cpp"} <= names


def test_native_library_is_the_ports_own():
    """Reading a PGM through the port's dataset reader builds and opens
    the port's own library (from csrc/native_io.cpp, into
    build/torch_kernels/), never the JAX package's native/ library."""
    code = (
        "import sys, numpy as np, pathlib, tempfile\n"
        "from direct_stereo_slam_tpu_torch.io import dataset, native\n"
        "d = tempfile.mkdtemp()\n"
        "p = pathlib.Path(d) / 'a.pgm'\n"
        "p.write_bytes(b'P5\\n4 2\\n255\\n' + bytes(range(8)))\n"
        "img = dataset._imread_gray(str(p))\n"
        "assert img.tolist() == [[0, 1, 2, 3], [4, 5, 6, 7]], img\n"
        "maps = [l.split()[-1] for l in open('/proc/self/maps') if l.strip().endswith('.so')]\n"
        "print('\\n'.join(sorted(set(maps))))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    libs = out.stdout.split()
    ours = [p for p in libs if "libdsslam_native_io_" in p]
    assert len(ours) == 1 and pathlib.Path(ours[0]).parent == REPO / "build" / "torch_kernels"
    assert not [p for p in libs if p.endswith("libdsslam_native.so")], libs
