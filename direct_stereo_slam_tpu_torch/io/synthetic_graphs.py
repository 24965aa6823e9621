"""Synthetic pose graphs and edges, made with numpy from a seed: the
inputs the pose-graph tests and ``chip_smoke.py``'s pose-graph phase
hold ``loop/pose_graph`` to.

``branch_edges`` puts the residual log(Z^-1 T_a^-1 T_b) of every edge at a
chosen rotation angle, on either side of each branch point of the Lie
functions (geometry/lie.py): the Taylor switch at theta^2 = 1e-4,
so3_log's theta = 1e-5 and theta = pi - 1e-2. ``ring_graph`` is a noisy
loop of keyframes (radius 8 m) with odometry edges and loop edges, sized
to land in a chosen bucket."""

import numpy as np

from direct_stereo_slam_tpu_torch.geometry.lie import se3_exp_np

# name -> residual rotation angle; each pair straddles a branch point
BRANCH_CASES = {
    "taylor_under": 0.0095,                 # theta^2 = 9.0e-5 < 1e-4
    "taylor_over": 0.0105,                  # theta^2 = 1.1e-4
    "so3_small_under": 5e-6,                # theta < 1e-5: 1 + theta^2 / 6
    "so3_small_over": 3e-5,
    "near_pi_under": np.pi - 2e-2,          # theta / sin(theta)
    "near_pi_over": np.pi - 4e-3,           # the axis from the diagonal
    "generic": 1.0,
    "zero": 0.0,
}


def branch_edges(theta: float, n: int = 6, seed: int = 0, t_scale: float = 0.7):
    """(T_a, T_b, Z) [n, 4, 4] f32 with Z^-1 T_a^-1 T_b = exp(t, theta * axis)
    on random axes (no axis along a coordinate: near pi the log takes the
    axis from square roots of the diagonal, whose derivative is not finite
    where a component is 0, in the JAX package as in the port)."""
    rng = np.random.RandomState(seed)
    Ta, Tb, Z = [], [], []
    for _ in range(n):
        a = se3_exp_np(np.r_[rng.randn(3), 0.5 * rng.randn(3)])
        z = se3_exp_np(np.r_[rng.randn(3), 0.5 * rng.randn(3)])
        axis = rng.randn(3)
        axis /= np.linalg.norm(axis)
        d = se3_exp_np(np.r_[t_scale * rng.randn(3), theta * axis])
        Ta.append(a)
        Z.append(z)
        Tb.append(a @ z @ d)
    f32 = lambda m: np.stack(m).astype(np.float32)
    return f32(Ta), f32(Tb), f32(Z)


def branch_graph(theta: float, n: int = 6, seed: int = 0):
    """``branch_edges`` as a graph: nodes 2i and 2i + 1 joined by edge i,
    and the last node fixed. Returns (poses, edges, fixed)."""
    Ta, Tb, Z = branch_edges(theta, n, seed)
    poses = np.stack([p for pair in zip(Ta, Tb) for p in pair])
    edges = [(2 * i, 2 * i + 1, Z[i], 1.0, 10.0) for i in range(n)]
    return poses, edges, 2 * n - 1


def ring_graph(n: int, seed: int = 0, loop_every: int = 0, fixed=None):
    """A drifting loop of n keyframes: odometry edges (i, i - 1) from the
    drifted poses (w_t 1, w_r 1e4), the closing edge (n - 1, 0) and, with
    ``loop_every``, an edge (i, i - loop_every // 2) every ``loop_every``
    nodes from the true poses (w_t 10, w_r 1e5). Returns (poses [n, 4, 4]
    f32, edges, fixed node: the newest unless given)."""
    rng = np.random.RandomState(seed)
    gt, est = [np.eye(4)], [np.eye(4)]
    for i in range(1, n):
        ang = 2 * np.pi * i / n
        T = np.eye(4)
        T[:3, :3] = se3_exp_np(np.r_[0, 0, 0, 0, -ang, 0])[:3, :3]
        T[0, 3] = 8 * np.sin(ang)
        T[2, 3] = 8 * (1 - np.cos(ang))
        gt.append(T)
        noise = se3_exp_np(rng.randn(6) * np.array([0.02, 0.005, 0.02, 0.001, 0.004, 0.001]))
        est.append(est[-1] @ np.linalg.inv(gt[i - 1]) @ gt[i] @ noise)
    est = np.stack(est).astype(np.float32)
    rel = lambda P, i, j: (np.linalg.inv(P[i]) @ P[j]).astype(np.float32)
    edges = [(i, i - 1, rel(est, i, i - 1), 1.0, 1e4) for i in range(1, n)]
    edges.append((n - 1, 0, rel(gt, n - 1, 0), 10.0, 1e5))
    if loop_every:
        for i in range(loop_every, n - 1, loop_every):
            j = i - loop_every // 2
            edges.append((i, j, rel(gt, i, j), 10.0, 1e5))
    return est, edges, n - 1 if fixed is None else fixed


def with_bad_loop(graph, a: int, b: int, theta: float, seed: int = 0):
    """``graph`` plus a wrong loop edge (a, b) whose residual at the given
    poses is a rotation by ``theta`` about a random axis (a loop closure
    off by ~pi: the Huber kernel downweights it, the rest of the graph
    keeps the system well posed)."""
    poses, edges, fixed = graph
    rng = np.random.RandomState(seed)
    axis = rng.randn(3)
    axis /= np.linalg.norm(axis)
    P = poses.astype(np.float64)
    Z = np.linalg.inv(P[a]) @ P[b] @ np.linalg.inv(se3_exp_np(np.r_[0.3 * rng.randn(3),
                                                                    theta * axis]))
    return poses, edges + [(a, b, Z.astype(np.float32), 1.0, 10.0)], fixed
