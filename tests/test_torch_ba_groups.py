"""The host side of the windowed BA's kernels (``ops/ba.py``), on the CPU:

- ``host_groups``, K9's grouping of the point pool by host, against a
  numpy reference (a stable argsort and a count per host): every point
  once, each host's points in ascending index, empty hosts, one slot, a
  pool hosted by one frame, sizes that are no multiple of K9's chunks;
- ``BaParams``, the ctypes mirror of ``csrc/ba.cu``'s parameter block:
  the same fields in the same order as the C struct, read from the
  source.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from direct_stereo_slam_tpu_torch.ops import ba as kb

CSRC = Path(kb.__file__).resolve().parents[1] / "csrc" / "ba_lin.cuh"


def _groups_ref(p_host: np.ndarray, W: int):
    pts = np.argsort(p_host, kind="stable").astype(np.int32)
    off = np.concatenate([[0], np.cumsum(np.bincount(p_host, minlength=W))]).astype(np.int32)
    return pts, off


@pytest.mark.parametrize("W,NP,case", [
    (1, 5, "random"), (2, 200, "random"), (4, 257, "random"), (8, 2560, "random"),
    (8, 4096, "random"), (8, 1001, "empty_hosts"), (8, 300, "one_host"),
    (3, 64, "sorted"), (8, 777, "reversed")])
def test_host_groups_match_numpy(W, NP, case):
    rng = np.random.RandomState(NP + W)
    if case == "empty_hosts":
        p_host = rng.choice([1, 4, 6], NP)
    elif case == "one_host":
        p_host = np.full(NP, W - 1)
    elif case == "sorted":
        p_host = np.sort(rng.randint(0, W, NP))
    elif case == "reversed":
        p_host = np.sort(rng.randint(0, W, NP))[::-1].copy()
    else:
        p_host = rng.randint(0, W, NP)
    pts, off = kb.host_groups(torch.as_tensor(p_host, dtype=torch.int64), W)
    want_pts, want_off = _groups_ref(p_host, W)
    assert pts.dtype == torch.int32 and off.dtype == torch.int32
    assert pts.is_contiguous() and off.shape == (W + 1,)
    np.testing.assert_array_equal(pts.numpy(), want_pts)
    np.testing.assert_array_equal(off.numpy(), want_off)
    assert sorted(pts.tolist()) == list(range(NP))
    for s in range(W):
        mine = pts[off[s]:off[s + 1]].numpy()
        assert np.all(p_host[mine] == s) and np.all(np.diff(mine) > 0)


def _c_fields(src: str):
    body = re.search(r"struct BaParams \{(.*?)\n\};", src, re.S).group(1)
    names = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        decl = line.rstrip(";").split()[-1] if "," not in line else line.rstrip(";")
        for part in (decl.split(",") if "," in line else [decl]):
            names.append(re.sub(r"[\*\s]|\[\d+\]", "", part.split()[-1]))
    return names


def test_params_struct_matches_the_c_source():
    names = _c_fields(CSRC.read_text())
    assert [n for n, _ in kb.BaParams._fields_] == names
    assert names.index("host_pts") + 1 == names.index("host_off")
