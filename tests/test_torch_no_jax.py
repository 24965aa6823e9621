"""The port stands alone: importing its SLAMNode (the whole device path),
the loop-closure modules, the evaluation harness, the host modules it
keeps its own copies of, the monocular bootstrap, the undistorter and
the ``run_slam`` entry point loads neither
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
            "common.cuh"} <= names
