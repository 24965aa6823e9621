"""Parity of the loop components with the JAX package: imitated-LiDAR scan
generation (atol 1e-9, the trim and range-gate cases of
test_loop_components.py and a multi-keyframe cloud), ringkey retrieval on
the numpy path and on the device path (``DEVICE_MIN`` lowered to 8 in both
modules' namespaces: identical candidates at every step), and the pose
graph on the graphs of test_loop_components.py (dense within 1e-4 of the
reference; CG within 2e-3 x scale of dense, the reference test's bound)."""

import numpy as np
import pytest
import jax.numpy as jnp

from direct_stereo_slam_tpu.config import make_config
from direct_stereo_slam_tpu.geometry import lie as lie_j
from direct_stereo_slam_tpu.loop import pose_graph as pg_j
from direct_stereo_slam_tpu.loop import retrieval as rt_j
from direct_stereo_slam_tpu.loop.scan import NearbyPointCloud as CloudJ
from direct_stereo_slam_tpu_torch.loop import pose_graph as pg_t
from direct_stereo_slam_tpu_torch.loop import retrieval as rt_t
from direct_stereo_slam_tpu_torch.loop.scan import NearbyPointCloud as CloudT
from direct_stereo_slam_tpu_torch.utils.convert import config_from_jax as port_cfg
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def _yaw(th):
    T = np.eye(4)
    T[:3, :3] = [[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]]
    return T


def _scan_case(case):
    """(keyframes [(kf_id, T_wc, world points)], T_cw of the scan)."""
    rng = np.random.RandomState(0)
    if case == "range_gate":
        return [(0, np.eye(4), rng.uniform(-30, 30, (500, 3)))], np.eye(4)
    if case == "orientation_trim":
        return [(0, np.eye(4), rng.uniform(-10, 10, (200, 3)))], np.linalg.inv(_yaw(1.2))
    # a turning walk: older keyframes trimmed, voxels shared across frames
    kfs = []
    for k in range(8):
        T = _yaw(0.15 * k)
        T[:3, 3] = [2.0 * np.sin(0.15 * k), 0.0, 3.0 * k]
        kfs.append((k, T, rng.uniform(-25, 25, (400, 3)) + T[:3, 3]))
    return kfs, np.linalg.inv(kfs[-1][1])


@pytest.mark.parametrize("case", ["range_gate", "orientation_trim", "multi_keyframe"])
def test_generate_scan_matches(case):
    cfg = make_config(320, 96)
    kfs, T_cw = _scan_case(case)
    cj, ct = CloudJ(cfg), CloudT(port_cfg(cfg))
    for kf_id, T_wc, pts in kfs:
        cj.add_keyframe_points(kf_id, T_wc, pts)
        ct.add_keyframe_points(kf_id, T_wc, pts)
        sj, st = cj.generate_scan(np.linalg.inv(T_wc)), ct.generate_scan(np.linalg.inv(T_wc))
        np.testing.assert_allclose(st, sj, atol=1e-9, rtol=0)
    sj, st = cj.generate_scan(T_cw), ct.generate_scan(T_cw)
    np.testing.assert_allclose(st, sj, atol=1e-9, rtol=0)
    np.testing.assert_array_equal(ct.ids, cj.ids)
    assert sorted(ct.id_pose_wc) == sorted(cj.id_pose_wc)
    if case == "orientation_trim":
        assert len(st) == 0
    else:
        assert len(st) > 50
        assert (np.linalg.norm(st, axis=1) < cfg.loop.lidar_range).all()


def _keys():
    """Ringkeys with revisits of earlier keys (and of key 0, which the
    reference never returns)."""
    rng = np.random.RandomState(0)
    keys = [rng.rand(20).astype(np.float32) for _ in range(60)]
    for i, j in ((25, 2), (31, 0), (40, 7), (47, 12), (55, 30), (59, 3)):
        keys[i] = keys[j] + 1e-3 * rng.rand(20).astype(np.float32)
    return keys


@pytest.mark.parametrize("device_min", [4096, 8])
def test_retrieval_candidates_identical(monkeypatch, device_min):
    monkeypatch.setattr(rt_j, "DEVICE_MIN", device_min)
    monkeypatch.setattr(rt_t, "DEVICE_MIN", device_min)
    dbj = rt_j.RingkeyDatabase(knn=3, loop_margin=5, ringkey_thres=0.1)
    dbt = rt_t.RingkeyDatabase(knn=3, loop_margin=5, ringkey_thres=0.1)
    found = []
    for i, k in enumerate(_keys()):
        cj, ct = dbj.search_and_insert(k), dbt.search_and_insert(k)
        assert ct == cj, (i, cj, ct)
        found += ct
    assert {2, 7, 12, 30, 3} <= set(found) and 0 not in found
    # the device path ran, and grew its buffer past the first capacity
    assert (dbt._buf is not None) == (device_min == 8)
    if device_min == 8:
        assert dbt._buf.shape[0] == 64


def _chain_graph():
    n = 12
    gt = []
    for i in range(n):
        T = np.eye(4)
        T[2, 3] = i * 1.0
        gt.append(T)
    est = [np.eye(4)]
    for _ in range(1, n):
        step = np.eye(4)
        step[2, 3] = 1.0
        step[0, 3] = 0.05
        est.append(est[-1] @ step)
    est = [e.astype(np.float32) for e in est]
    edges = [(i, i - 1, (np.linalg.inv(est[i]) @ est[i - 1]).astype(np.float32), 1.0, 1e4)
             for i in range(1, n)]
    edges.append((n - 1, 0, (np.linalg.inv(gt[n - 1]) @ gt[0]).astype(np.float32), 10.0, 1e5))
    return np.stack(est), edges, n - 1, 25


def _info_graph(w_t, w_r):
    est = np.stack([np.eye(4, dtype=np.float32)] * 2)
    T_tgt = np.asarray(lie_j.se3_exp(jnp.asarray([1.0, 0, 0, 0, 0, 0.3], jnp.float32)))
    edges = [(1, 0, np.eye(4, dtype=np.float32), 1.0, 1.0),
             (1, 0, (np.linalg.inv(est[1]) @ T_tgt).astype(np.float32), w_t, w_r)]
    return est, edges, 1, 20


def _ring_graph():
    rng = np.random.RandomState(3)
    n = 40
    gt, est = [np.eye(4, dtype=np.float32)], [np.eye(4, dtype=np.float32)]
    for i in range(1, n):
        ang = 2 * np.pi * i / n
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 8 * np.sin(ang)
        T[2, 3] = 8 * (1 - np.cos(ang))
        gt.append(T)
        xi = rng.randn(6).astype(np.float32) * np.array(
            [0.02, 0.005, 0.02, 0.001, 0.004, 0.001], np.float32)
        D = np.asarray(lie_j.se3_exp(jnp.asarray(xi)))
        est.append((est[-1] @ np.linalg.inv(gt[i - 1]) @ gt[i] @ D).astype(np.float32))
    edges = [(i, i - 1, (np.linalg.inv(est[i]) @ est[i - 1]).astype(np.float32), 1.0, 1e4)
             for i in range(1, n)]
    edges.append((n - 1, 0, (np.linalg.inv(gt[n - 1]) @ gt[0]).astype(np.float32), 10.0, 1e5))
    return np.stack(est), edges, n - 1, 15


GRAPHS = {"chain": _chain_graph, "info_t": lambda: _info_graph(1e6, 1.0),
          "info_r": lambda: _info_graph(1.0, 1e6), "ring": _ring_graph}


@pytest.mark.parametrize("name", list(GRAPHS))
def test_pose_graph_dense_matches(name):
    poses, edges, fixed, iters = GRAPHS[name]()
    n = len(poses)
    Tj = np.asarray(pg_j.optimize(pg_j.build_data(poses, edges, fixed), iters))
    dt = pg_t.build_data(poses, edges, fixed)
    Tt = pg_t.optimize(dt, iters).numpy()
    np.testing.assert_allclose(Tt[:n], Tj[:n], atol=1e-4, rtol=0)
    np.testing.assert_allclose(Tt[fixed], poses[fixed], atol=1e-4)
    assert dt.T_wc.shape[0] == pg_t.next_bucket(n) == pg_j.next_bucket(n)


@pytest.mark.parametrize("name", ["chain", "ring"])
def test_pose_graph_cg_matches_dense(name):
    poses, edges, fixed, iters = GRAPHS[name]()
    n = len(poses)
    data = pg_t.build_data(poses, edges, fixed)
    T_dense = pg_t.optimize(data, iters, solver="dense").numpy()
    T_cg = pg_t.optimize(data, iters, solver="cg").numpy()
    scale = np.abs(T_dense[:, :3, 3]).max()
    np.testing.assert_allclose(T_cg[:n], T_dense[:n], atol=2e-3 * scale)
    # "auto" takes the dense solver at this size (<= 512 nodes)
    np.testing.assert_array_equal(pg_t.optimize(data, iters).numpy(), T_dense)
