"""Build, load and call the port's hand-written CUDA kernels.

All kernels live in ``direct_stereo_slam_tpu_torch/csrc/*.cu`` behind a
plain C interface. On first use each source is compiled with ``nvcc`` for
Hopper (``sm_90a``), one ``nvcc`` per source, all started together, and
the objects are linked into one shared library under
``build/torch_kernels/`` at the repository root, named by a digest of the
sources and flags so an edited source is rebuilt; the library is loaded
with ``ctypes``. Nothing
here runs at import time, and there is no fallback: a missing toolkit, a
failed build or a refused launch raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

import torch

# The reference pins Precision.HIGHEST for its geometry and H/b matmuls;
# on the card that means no TF32 in matmuls or cuDNN convolutions. Set
# once here, where every module of the device path imports this one.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures of the exported entry points (csrc/*.cu); every entry
# returns a cudaError_t as int and launches on the stream passed last.
_SIGNATURES = {
    # pu, pv, mask, n, out, h2, w2, stream
    "dsslam_distance_map": [_P, _P, _P, _I, _P, _I, _I, _P],
    # img, H, W, umax, vmax, pu, pv, pid, pcolor, pmask, N, params, B,
    # fx, fy, cx, cy, huber, compute_flow, partial, nblk, out, stream
    "dsslam_pose_pass": [_P, _I, _I, _F, _F, _P, _P, _P, _P, _P, _I, _P, _I,
                         _F, _F, _F, _F, _F, _I, _P, _I, _P, _P],
    # img, H, W, umax, vmax, pu, pv, pid, pcolor, pmask, N, params, G,
    # fx, fy, cx, cy, huber, partial, nblk, out, stream
    "dsslam_scale_pass": [_P, _I, _I, _F, _F, _P, _P, _P, _P, _P, _I, _P, _I,
                          _F, _F, _F, _F, _F, _P, _I, _P, _P],
    # img, H, W, umax, vmax, px, py, pz, pcolor, pmask, N, params, S,
    # fx, fy, cx, cy, huber, partial, nblk, out, stream
    "dsslam_pose3d_pass": [_P, _I, _I, _F, _F, _P, _P, _P, _P, _P, _I, _P, _I,
                           _F, _F, _F, _F, _F, _P, _I, _P, _P],
    # &LmParams (ops/resident_lm.py), stream
    "dsslam_track_lm": [_P, _P],
    "dsslam_loop_pose_lm": [_P, _P],
    # &ScaleLmParams (ops/resident_lm.py), stream
    "dsslam_scale_lm": [_P, _P],
    # H, g, lam, mode_a, mode_b, n, inc, piv, stream
    "dsslam_lm_solve": [_P, _P, _P, _F, _F, _I, _P, _P, _P],
    # T, x, T_out, N, Z, a, b, w_t, w_r, valid, E, delta, delta_sq, H, g,
    # stream
    "dsslam_pose_graph_edges": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _F, _F, _P,
                                _P, _P],
    # T, x, N, Z, a, b, w_t, w_r, valid, E, delta, delta_sq, node_valid,
    # fixed, lam, iterations, stop, P, x, r, words, H, g, A, L, T_out,
    # timers, stream
    "dsslam_pose_graph_gn": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _F, _F, _P, _P, _F, _I,
                             _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    # N, E, out[4] (host only: no stream)
    "dsslam_pose_graph_gn_grid": [_I, _I, _P],
    # H, g, a, b, valid, E, inc_off, inc_ent, node_valid, fixed, N, damp,
    # cg_iters, work, x, steps, timers, stream
    "dsslam_pose_graph_pcg": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _F, _I, _P, _P,
                              _P, _P, _P],
    # T, N, Z, a, b, w_t, w_r, valid, E, delta, delta_sq, node_valid, fixed,
    # damp, iterations, cg_iters, work, inc, H, g, x, T_out, steps, timers,
    # stream
    "dsslam_pose_graph_cg": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _F, _F, _P, _P, _F, _I, _I,
                             _P, _P, _P, _P, _P, _P, _P, _P, _P],
    # N (host only: no stream)
    "dsslam_pose_graph_cg_work": [_I],
    # &BaParams (ops/ba.py), mode / it, stream
    "dsslam_ba_linearize": [_P, _I, _P],
    "dsslam_ba_step": [_P, _P],
    "dsslam_ba_accept": [_P, _I, _P],
    # &BaParams, iterations, stream
    "dsslam_ba_optimize": [_P, _I, _P],
    # W, NP, out[6] (host only: no stream)
    "dsslam_ba_optimize_grid": [_I, _I, _P],
    # &GateParams / &AllocParams (ops/activate.py), stream
    "dsslam_gate_activate": [_P, _P],
    "dsslam_allocate_insert": [_P, _P],
    # &TraceParams (ops/trace.py), grid, stream
    "dsslam_trace": [_P, _I, _P],
    # &TemplateParams (ops/template.py), stream
    "dsslam_template": [_P, _P],
    # H, W, levels, grid, n, out[3] (host only: no stream)
    "dsslam_template_sizes": [_I, _I, _I, _I, _I, _P],
}


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME unset, no nvcc)")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found under {CUDA_HOME}")
    return str(nvcc)


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libdsslam_kernels_{digest.hexdigest()[:16]}.so"


class KernelLibrary:
    """The loaded shared library plus what its build reported (nvcc's and
    ptxas's output, kept beside the library)."""

    def __init__(self, lib: ctypes.CDLL, path: Path, build_seconds: float,
                 build_log: str):
        self.lib = lib
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log


@functools.lru_cache(maxsize=None)
def load_library() -> KernelLibrary:
    """Build (if needed) and load the kernel library; cached per process."""
    path = library_path()
    t0 = time.perf_counter()
    log = ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
            objs, procs = [], []
            for src in (s for s in _sources() if s.suffix == ".cu"):
                obj = os.path.join(tmpdir, src.stem + ".o")
                objs.append(obj)
                procs.append(subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o", obj, str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            outs = [(proc.communicate()[0], proc.returncode) for proc in procs]
            log = "".join(out for out, _ in outs)
            if any(rc != 0 for _, rc in outs):
                raise RuntimeError(f"nvcc failed:\n{log}")
            tmp = os.path.join(tmpdir, path.name)
            proc = subprocess.run([nvcc, "-shared", "-o", tmp, *objs], capture_output=True,
                                  text=True)
            log += proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to link ({proc.returncode}):\n{log}")
            path.with_suffix(".log").write_text(log)
            os.replace(tmp, path)       # atomic: concurrent builds agree
    elif path.with_suffix(".log").exists():
        log = path.with_suffix(".log").read_text()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.dsslam_error_string.argtypes = [ctypes.c_int]
    lib.dsslam_error_string.restype = ctypes.c_char_p
    return KernelLibrary(lib, path, time.perf_counter() - t0, log)


def call(name: str, *args) -> None:
    """Launch one entry point on the current stream; raise on any CUDA
    error the launch reports."""
    kl = load_library()
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(kl.lib, name)(*args, stream)
    if err != 0:
        msg = kl.lib.dsslam_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The card's SMs: a cooperative kernel's grid, a block an SM (its
    launch fails unless every block is resident)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def require_cuda(name: str, *tensors: torch.Tensor,
                 dtypes=(torch.float32, torch.uint8)) -> None:
    """The kernels take contiguous CUDA tensors on one device, read as f32
    (data) or uint8 (masks), or as the ``dtypes`` a kernel names (indices)."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: tensors must be one of {dtypes}, got {t.dtype}")
