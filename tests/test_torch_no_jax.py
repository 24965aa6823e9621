"""The port stands without JAX: importing its SLAMNode (the whole device
path), the loop-closure modules, the evaluation harness and the
``run_slam`` entry point loads no ``jax``, no module of the port imports
jax, and the device path turns TF32 off (the reference pins full-f32
matmuls). Of the JAX package the port shares only jax-free host modules
(config, calib, dataset, sync, Scan Context, ICP and the signature
search)."""

import os
import pathlib
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
        "import torch\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib'))\n"
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


def test_no_port_source_imports_jax():
    offenders = []
    for path in PKG.rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import jax", "from jax")) or "import jax" in s.split("#")[0]:
                offenders.append(f"{path.relative_to(REPO)}: {s}")
    assert not offenders, offenders


def test_kernel_sources_present():
    names = {p.name for p in (PKG / "csrc").iterdir()}
    assert {"distance_map.cu", "residual_hb.cu", "common.cuh"} <= names
