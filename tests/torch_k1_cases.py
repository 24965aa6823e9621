"""K1's (the distance map's) edge cases, shared by the card tests
(tests/test_torch_cuda_kernels.py) and the CPU tests against the JAX
package (tests/test_torch_distance_map.py)."""

import numpy as np

# K1's edge cases: grids of one cell, one row, one column and sizes that
# are no multiple of a tile; points on every border and corner and exactly
# half a cell off them (rounded half to even), points outside the grid
# (clipped onto its border) beside masked ones, every cell occupied, and
# one isolated point 15, 16 and 17 cells from the left and top borders
# (the cap at MAX_DIST = 16 decides the far side).
K1_GRIDS = [(1, 1), (1, 616), (184, 1), (33, 65)]
K1_CASES = ["borders", "outside", "full", "iso15", "iso16", "iso17"]


def k1_points(case, h2, w2):
    """(pu, pv, mask) of one of K1_CASES on an h2 x w2 grid, padded with
    masked points to max(64, h2 * w2) entries."""
    rng = np.random.RandomState(h2 * 1000 + w2)
    if case == "borders":
        xs, ys = [], []
        for x in (0.0, w2 - 1.0, (w2 - 1) / 2.0, -0.5, w2 - 0.5, 0.5, w2 - 1.5):
            xs += [x, x]
            ys += [0.0, h2 - 1.0]
        for y in ((h2 - 1) / 2.0, -0.5, h2 - 0.5, 0.5, h2 - 1.5):
            xs += [0.0, w2 - 1.0, (w2 - 1) // 2 + 0.5]
            ys += [y, y, y]
        pu, pv = np.array(xs), np.array(ys)
        mask = np.ones(len(pu), bool)
    elif case == "outside":
        pu = np.concatenate([rng.uniform(-60, -0.6, 12), rng.uniform(w2 - 0.4, w2 + 60, 12),
                             rng.uniform(-60, w2 + 60, 16), rng.uniform(0, w2 - 1, 8)])
        pv = np.concatenate([rng.uniform(-60, h2 + 60, 24),
                             np.where(np.arange(16) < 8, rng.uniform(-60, -0.6, 16),
                                      rng.uniform(h2 - 0.4, h2 + 60, 16)),
                             rng.uniform(0, h2 - 1, 8)])
        mask = np.arange(len(pu)) < 40                 # the 8 inside are masked
    elif case == "full":
        pv, pu = (a.reshape(-1) + rng.uniform(-0.49, 0.49, h2 * w2)
                  for a in np.mgrid[0:h2, 0:w2].astype(np.float64))
        mask = np.ones(h2 * w2, bool)
    else:
        k = int(case[3:])
        pu, pv = np.array([min(k, w2 - 1)], float), np.array([min(k, h2 - 1)], float)
        mask = np.ones(1, bool)
    n = max(64, h2 * w2)
    pad = n - len(pu)
    return (np.concatenate([pu, np.zeros(pad)]).astype(np.float32),
            np.concatenate([pv, np.zeros(pad)]).astype(np.float32),
            np.concatenate([mask, np.zeros(pad, bool)]))
