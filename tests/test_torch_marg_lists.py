"""K18's host-built inputs (``ops/window.py::marg_lists``): the flags
(bit 0 marginalize, bit 1 drop), the flagged valid points in ascending
order (the Schur sums' order) and the same points grouped by host with
each host's offsets (K9's pixel pass's lists, ``host_groups``' order),
against a brute-force ordering in plain Python on seeded masks: none
flagged, all flagged, flagged points that are not valid, one host only,
the last host only, one point, and W of 1 to 8.
"""

import numpy as np
import pytest

from direct_stereo_slam_tpu_torch.ops import window as win

CASES = [  # (W, NP, kind)
    (1, 1, "all"), (2, 64, "none"), (3, 100, "random"), (4, 256, "invalid"),
    (5, 300, "one_host"), (8, 4096, "random"), (8, 4096, "last_host"), (8, 777, "one_point"),
    (6, 2048, "all")]


def _masks(W, NP, kind, seed):
    rng = np.random.RandomState(seed)
    valid = rng.rand(NP) < 0.8
    host = rng.randint(0, W, NP).astype(np.int64)
    marg = rng.rand(NP) < 0.2
    if kind == "none":
        marg[:] = False
    elif kind == "all":
        marg[:] = True
        valid[:] = True
    elif kind == "invalid":
        marg |= ~valid                   # every invalid point flagged too
    elif kind == "one_host":
        marg &= host == 2
    elif kind == "last_host":
        marg &= host == W - 1
    elif kind == "one_point":
        marg[:] = False
        marg[NP // 2] = valid[NP // 2] = True
    drop = ~marg & (rng.rand(NP) < 0.1)
    return marg, drop, valid, host


@pytest.mark.parametrize("W,NP,kind", CASES)
def test_marg_lists_match_brute_force(W, NP, kind):
    marg, drop, valid, host = _masks(W, NP, kind, 31 * W + NP)
    got = win.marg_lists(marg, drop, valid, host, W)
    flagged = [i for i in range(NP) if marg[i] and valid[i]]
    by_host = [i for h in range(W) for i in flagged if host[i] == h]
    off = [0]
    for h in range(W):
        off.append(off[-1] + sum(1 for i in flagged if host[i] == h))
    assert got.mlist.dtype == np.int32 and got.host_pts.dtype == np.int32
    assert got.mlist.tolist() == flagged
    assert got.host_pts.tolist() == by_host
    assert got.host_off.dtype == np.int32 and got.host_off.tolist() == off
    assert got.flags.dtype == np.uint8
    assert got.flags.tolist() == [int(m) | (int(d) << 1) for m, d in zip(marg, drop)]
