"""The loop thread's device-side choices and uploads, on the CPU:

- ``pose_estimator.estimate_batch`` takes the best seed on the device
  (``best_seed`` + ``_take``: ``index_select`` with a [1] index, no host
  int). Its result must equal the per-field indexing ``_index(res, i)``
  bit for bit, and the JAX package's ``estimate_batch`` must choose the
  same seed, in each branch of the choice: a passing seed, none passing
  but some seed visible, none visible, and ties (the first index wins).
  Both packages' seed estimates are replaced by the same table of seed
  results (encoded in the seed poses), so only the choice is compared.
- ``utils.device.upload`` (the pinned one-copy upload of a loop try's
  inputs and of ``pose_graph.build_data``'s arrays) keeps each array's
  values, dtype and shape.

The card's side (no synchronizing call but the designed reads) is
``tests/test_torch_cuda_loop_waits.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from direct_stereo_slam_tpu.config import make_config
from direct_stereo_slam_tpu.loop import pose_estimator as pe_j
from direct_stereo_slam_tpu.models.tracker import AffLight as AffJ
from direct_stereo_slam_tpu_torch.loop import pose_estimator as pe_t
from direct_stereo_slam_tpu_torch.loop import pose_graph as pg_t
from direct_stereo_slam_tpu_torch.models.tracker import AffLight as AffT
from direct_stereo_slam_tpu_torch.utils.convert import config_from_jax as port_cfg
from direct_stereo_slam_tpu_torch.utils.device import upload

# per seed: (pose_error, inlier_ratio, ok, ok_res); inner_percent is 90
CASES = {
    "passing": [(3.0, 95.0, 0, 1), (2.5, 97.0, 1, 1), (1.0, 50.0, 0, 1), (2.0, 92.0, 1, 1),
                (4.0, 99.0, 1, 0), (0.5, 0.0, 0, 1)],
    "none_passing_visible": [(3.0, 95.0, 0, 1), (1.0, 40.0, 0, 1), (2.5, 91.0, 0, 0),
                             (0.0, 0.0, 0, 1), (0.7, 10.0, 0, 1), (9.0, 96.0, 0, 0)],
    "none_visible": [(0.0, 0.0, 0, 1), (0.0, 0.0, 0, 0), (5.0, 0.0, 0, 1),
                     (0.0, 0.0, 0, 1), (1.0, 0.0, 0, 0), (0.0, 0.0, 0, 1)],
    "ties": [(3.0, 95.0, 0, 1), (2.0, 93.0, 1, 1), (2.0, 99.0, 1, 1), (2.0, 91.0, 1, 0),
             (1.0, 30.0, 0, 1), (2.0, 96.0, 1, 1)],
}
EXPECTED = {"passing": 3, "none_passing_visible": 2, "none_visible": 0, "ties": 1}


def _seed_poses(table) -> np.ndarray:
    """[S, 4, 4] seeds carrying each seed's result in their bottom row and
    last column (read back by the replaced estimates below)."""
    rng = np.random.default_rng(7)
    T = rng.normal(size=(len(table), 4, 4)).astype(np.float32)
    for i, (err, inl, ok, ok_res) in enumerate(table):
        T[i, 3, 0], T[i, 3, 1] = err, inl
        T[i, 0, 3], T[i, 1, 3] = ok, ok_res
    return T


def _fields(T, mod, aff):
    ok = T[..., 0, 3] > 0.5
    ok_res = T[..., 1, 3] > 0.5
    return mod.LoopPoseResult(T=T, pose_error=T[..., 3, 0], inlier_ratio=T[..., 3, 1],
                              aff=aff(T[..., 3, 2], T[..., 2, 3]), ok=ok, ok_res=ok_res,
                              ok_inlier=T[..., 3, 1] > 90.0, ok_aff=ok | ok_res)


class _JaxEstimate:
    """Stands in for the JAX package's ``estimate``: ``estimate_batch``
    vmaps ``estimate.__wrapped__`` over the seeds."""

    @staticmethod
    def __wrapped__(pyr, px, py, pz, pcolors, pmask, T0, intr, cfg, ref_exp, new_exp):
        return _fields(T0, pe_j, AffJ)


@pytest.mark.parametrize("case", sorted(CASES))
def test_best_seed_on_the_device_matches_indexing_and_jax(monkeypatch, case):
    cfg_j = make_config(96, 48)
    cfg_t = port_cfg(cfg_j)
    T = _seed_poses(CASES[case])
    monkeypatch.setattr(pe_j, "estimate", _JaxEstimate)
    rj = pe_j.estimate_batch.__wrapped__((), None, None, None, None, None, jnp.asarray(T),
                                         None, cfg_j)
    res_t = _fields(torch.from_numpy(T), pe_t, AffT)
    monkeypatch.setattr(pe_t, "estimate_seeds", lambda *a, **kw: res_t)
    rt = pe_t.estimate_batch((), None, None, None, None, None, torch.from_numpy(T), None,
                             cfg_t)

    idx = pe_t.best_seed(res_t, cfg_t)
    assert idx.shape == (1,) and int(idx) == EXPECTED[case]
    want = pe_t._index(res_t, int(idx))
    got = rt.best
    for name, g, w, j in zip(pe_t.LoopPoseResult._fields, got, want, rj.best):
        g, w, j = (list(x) if name == "aff" else [x] for x in (g, w, j))
        for gi, wi, ji in zip(g, w, j):
            assert gi.dtype == wi.dtype and gi.shape == wi.shape, name
            assert torch.equal(gi, wi), name
            assert np.array_equal(gi.numpy(), np.asarray(ji)), name


def test_upload_keeps_values_dtypes_and_shapes():
    arrays = (np.arange(7, dtype=np.float32), np.array([True, False, True]),
              np.arange(6, dtype=np.int64).reshape(2, 3), np.int64(5),
              np.zeros((0, 4), np.float32), np.eye(4, dtype=np.float32)[None])
    got = upload(arrays, torch.device("cpu"))
    for a, t in zip(arrays, got):
        a = np.asarray(a)
        assert t.dtype == torch.from_numpy(a.reshape(-1)[:0]).dtype
        assert tuple(t.shape) == a.shape
        assert np.array_equal(t.numpy(), a)


def test_build_data_fields():
    poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    poses[:, :3, 3] = np.arange(9, dtype=np.float32).reshape(3, 3)
    Z = np.eye(4, dtype=np.float32)
    data = pg_t.build_data(poses, [(1, 0, Z, 2.0, 3.0), (2, 1, Z, 4.0, 5.0)], 2)
    assert data.T_wc.shape == (16, 4, 4) and torch.equal(data.T_wc[:3],
                                                         torch.from_numpy(poses))
    assert data.node_valid.dtype == torch.bool and int(data.node_valid.sum()) == 3
    assert data.edge_a.tolist()[:3] == [1, 2, 0] and data.edge_a.dtype == torch.int64
    assert data.edge_w_t.tolist()[:3] == [2.0, 4.0, 0.0]
    assert data.edge_valid.tolist()[:3] == [True, True, False]
    assert data.fixed_node.shape == () and int(data.fixed_node) == 2
