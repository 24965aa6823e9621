"""The loop thread's device work on the card makes no host read but the
two designed ones (``loop/handler.py``: a try's one read of its best
seed, and the optimize's result):

- a direct try's uploads and ``estimate_batch`` (``_direct_launch``: the
  inputs through one pinned copy, K4-LM, the best seed taken with
  ``index_select``) under ``torch.cuda.set_sync_debug_mode("error")``,
  equal to the per-field indexing of the seeds' results;
- the pose graph's ``build_data`` (``graph_data``) and ``optimize`` (one
  K7 launch) under the same mode: every field equal to the graph's
  arrays uploaded as pageable copies, and the optimize equal to one of
  that pageable graph;
- ``utils/device.upload`` on the card (one pinned buffer, each array at
  a 256-byte offset, viewed back by dtype): mixed dtypes, a 0-d int64,
  an empty array and sizes that are not multiples of 256, against the
  numpy arrays.

These tests need a CUDA card and skip elsewhere. They import nothing of
JAX, so on the card's machine they run without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_loop_waits.py
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from direct_stereo_slam_tpu_torch.config import make_config
from direct_stereo_slam_tpu_torch.geometry.camera import make_pyramid_intrinsics
from direct_stereo_slam_tpu_torch.loop import pose_estimator as pe
from direct_stereo_slam_tpu_torch.loop import pose_graph as pg
from direct_stereo_slam_tpu_torch.loop.handler import LoopFrame, LoopHandler
from direct_stereo_slam_tpu_torch.ops import pose_graph as pgk
from direct_stereo_slam_tpu_torch.ops import resident_lm as rlm
from direct_stereo_slam_tpu_torch.ops.pyramid import build_pyramid
from direct_stereo_slam_tpu_torch.utils.device import upload

pytestmark = pytest.mark.cuda

W, H = 320, 96


@pytest.fixture(scope="module")
def setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    dev = torch.device("cuda")
    cfg = make_config(W, H)
    L = cfg.tracker.pyr_levels
    intr = make_pyramid_intrinsics(250.0, 250.0, W / 2, H / 2, W, H, L)
    rng = np.random.default_rng(3)
    img = torch.as_tensor(rng.uniform(0, 255, (H, W)).astype(np.float32), device=dev)
    img = torch.nn.functional.avg_pool2d(img[None, None], 5, 1, 2)[0, 0]
    pyr = tuple(build_pyramid(img, L).data)
    K = 600
    pts = np.stack([rng.uniform(-2, 2, K), rng.uniform(-0.6, 0.6, K), rng.uniform(3, 9, K)],
                   1).astype(np.float32)
    matched = SimpleNamespace(pts_cam=pts, pts_colors=rng.uniform(0, 255, (K, L))
                              .astype(np.float32), exposure=1.0)
    seed = np.eye(4)
    seed[:3, 3] = (0.05, -0.02, 0.1)
    handler = LoopHandler(cfg, intr, threaded=False, device=dev)
    args = (SimpleNamespace(pyr=pyr), SimpleNamespace(exposure=1.0), matched, seed, seed,
            np.eye(4), True, False)
    return SimpleNamespace(dev=dev, cfg=cfg, handler=handler, args=args)


def _raising_on_sync(fn):
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_direct_try_makes_no_host_read(setup):
    h = setup.handler
    h._direct_launch(*setup.args)                 # build and load the kernels first
    before = rlm.loop_pose_lm_cuda.launches
    bres = _raising_on_sync(lambda: h._direct_launch(*setup.args))
    assert rlm.loop_pose_lm_cuda.launches - before == 1
    # the seeds' own results, and the best one by per-field indexing
    seeds = pe.estimate_seeds(tuple(setup.args[0].pyr), *_inputs(setup), h.intr, setup.cfg)
    want = pe._index(seeds, int(pe.best_seed(seeds, setup.cfg)))
    for name, g, w in zip(pe.LoopPoseResult._fields, bres.best, want):
        for gi, wi in zip(*(list(x) if name == "aff" else [x] for x in (g, w))):
            assert torch.equal(gi, wi), name
    vals, n_ok = h._direct(*setup.args)           # the try's one designed read
    assert n_ok == int(seeds.ok.sum()) and np.isfinite(vals["pose_error"])


def _inputs(setup):
    """A try's arrays as ``_direct_launch`` builds them, uploaded as
    pageable copies."""
    h, (mkf, lf, matched, pca, icp, odo, icp_ok, ref_mode) = setup.handler, setup.args
    kmax, L = setup.cfg.loop.max_loop_points, setup.cfg.tracker.pyr_levels
    k = min(len(matched.pts_cam), kmax)
    px, py, pz = np.zeros(kmax, np.float32), np.zeros(kmax, np.float32), np.ones(kmax,
                                                                                np.float32)
    cols, mask = np.zeros((kmax, L), np.float32), np.zeros(kmax, bool)
    px[:k], py[:k], pz[:k] = matched.pts_cam[:k].T
    cols[:k] = matched.pts_colors[:k]
    mask[:k] = True
    stack = pe.make_seed_stack(icp, (odo,), tuple(setup.cfg.loop.seed_yaw_perturb_deg))
    t = lambda a: torch.as_tensor(a, device=setup.dev)
    return t(px), t(py), t(pz), t(cols), t(mask), t(stack)


def test_graph_build_and_optimize_make_no_host_read(setup):
    h = setup.handler
    rng = np.random.default_rng(5)
    h.frames = []
    for i in range(40):
        T = np.eye(4)
        T[:3, 3] = (np.cos(i / 6.0) * 8, 0.0, np.sin(i / 6.0) * 8)
        lf = LoopFrame(kf_id=i, incoming_id=i, T_wc=T, t_wc_orig=T[:3, 3].copy(),
                       dso_error=1.0, scale_error=1.0)
        if i:
            Z = np.linalg.inv(h.frames[-1].T_wc) @ T
            Z[:3, 3] += rng.normal(0, 0.02, 3)
            lf.edges.append((i - 1, Z, 100.0, 1000.0))
        h.frames.append(lf)
    h.frames[-1].edges.append((0, np.linalg.inv(h.frames[0].T_wc) @ h.frames[-1].T_wc,
                               50.0, 500.0))
    data, _ = h.graph_data()
    pg.optimize(data, 2)                          # build and load the kernels first
    before = pgk.pose_graph_gn_cuda.launches
    T_opt = _raising_on_sync(lambda: pg.optimize(h.graph_data()[0], 25))
    assert pgk.pose_graph_gn_cuda.launches - before == 1
    # the same graph's arrays (build_data on the CPU packs nothing) as
    # pageable copies
    poses32 = np.stack([lf.T_wc for lf in h.frames]).astype(np.float32)
    edges = [(i, j, np.asarray(Z, np.float32), w_t, w_r)
             for i, lf in enumerate(h.frames) for (j, Z, w_t, w_r) in lf.edges]
    arrays = pg.build_data(poses32, edges, len(h.frames) - 1, device="cpu")
    pageable = pg.PoseGraphData(*[torch.as_tensor(x.numpy(), device=setup.dev)
                                  for x in arrays])
    for name, got, want in zip(pg.PoseGraphData._fields, data, pageable):
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert torch.equal(got, want), name
    assert torch.equal(T_opt, pg.optimize(pageable, 25))
    assert torch.isfinite(T_opt).all()


def test_upload_on_the_card_keeps_values_dtypes_and_shapes(setup):
    rng = np.random.default_rng(11)
    arrays = (rng.normal(size=7).astype(np.float32), np.array([True, False, True]),
              np.arange(6, dtype=np.int64).reshape(2, 3), np.int64(-5),
              np.zeros((0, 4), np.float32), rng.normal(size=(3, 4, 4)).astype(np.float32),
              rng.integers(0, 255, 300, dtype=np.uint8), rng.normal(size=65),
              rng.integers(-9, 9, (5, 13), dtype=np.int32), np.float32(2.5))
    got = _raising_on_sync(lambda: upload(arrays, setup.dev))
    base = got[0].untyped_storage().data_ptr()
    for a, t in zip(arrays, got):
        a = np.asarray(a)
        assert t.device.type == "cuda" and t.untyped_storage().data_ptr() == base
        assert (t.data_ptr() - base) % 256 == 0
        assert t.dtype == torch.from_numpy(a.reshape(-1)[:0]).dtype
        assert tuple(t.shape) == a.shape
        assert np.array_equal(t.cpu().numpy(), a)
