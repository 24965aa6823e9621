"""Batch evaluation over sequences (port of parallel/mesh.py).

SLAM state is sequential per sequence, so the scale-out of the reference's
headless batch evaluation (BASELINE.json config 5, KITTI 00-10) is data
parallelism over sequences: one step tracks the new frame of each of S
sequences against its own template and optimizes its stereo scale.

On one card the JAX package's mesh axis is a batch axis: ``step`` builds
one pyramid stack per camera and makes one launch of K2-LM (S sequences x
one candidate) and one of K3-LM (S sequences x one guess at scale 1), the
kernels' sequence axis (``ops/resident_lm.py``). On the CPU it is the
plain loop of ``track_candidate`` and ``optimize_scale_single`` over the
sequences.

``Mesh`` is a list of devices named by one axis, ``"seq"``. The
``shard_*`` functions split their leading axis (sequences, windows,
candidates, guesses or edges) into contiguous shards in device order, run
each shard on its device and gather the results on the first device: the
counterpart of ``shard_map`` with ``all_gather`` / ``psum``, where partial
sums are added over the shards in device order. The card's machine has
one card, so there each is one shard; no ``torch.distributed``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..config import SLAMConfig
from ..geometry import lie
from ..geometry.camera import PyramidIntrinsics
from ..models.depth_template import TrackerTemplate
from ..models.scale_opt import optimize_scale_batch, optimize_scale_single
from ..models.tracker import AffLight, track_candidate, track_candidates_batch
from ..ops.pyramid import build_pyramid
from ..ops.resident_lm import scale_lm_cuda, track_lm_cuda
from ..utils.device import resolve_device

# the stereo extrinsics of the batched step: the KITTI rig's 0.54 m
# baseline (mesh.py:69-72 of the JAX package)
_T10 = np.eye(4, dtype=np.float32)
_T10[0, 3] = -0.54


class BatchedStepOut(NamedTuple):
    T: torch.Tensor          # [B, 4, 4] tracked ref->new poses
    res: torch.Tensor        # [B] finest-level residuals
    scale: torch.Tensor      # [B] optimized stereo scale
    scale_err: torch.Tensor  # [B]


class Mesh(NamedTuple):
    """Devices along the one axis ``"seq"``."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("seq",)

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """A mesh of ``n_devices`` devices of ``device``'s type (all visible
    cards by default; on the CPU, ``cpu`` named n times, default once).
    Raises when fewer cards are visible than asked for."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        visible = torch.cuda.device_count()
        n = visible if n_devices is None else n_devices
        if visible < n:
            raise RuntimeError(f"make_mesh: requested {n} devices but only {visible} "
                               f"CUDA cards visible")
        return Mesh(tuple(torch.device("cuda", i) for i in range(n)))
    return Mesh((dev,) * (1 if n_devices is None else n_devices))


def _tree(x, fn):
    """fn over the leaves of a tensor, a tuple/NamedTuple of them, nested."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple):
        leaves = [_tree(v, fn) for v in x]
        return type(x)(*leaves) if hasattr(x, "_fields") else tuple(leaves)
    return x


def _stack(parts: Sequence, dev: torch.device):
    """The parts' leaves concatenated on their leading axis, on dev."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([p.to(dev) for p in parts])
    leaves = [_stack([p[i] for p in parts], dev) for i in range(len(first))]
    return type(first)(*leaves) if hasattr(first, "_fields") else tuple(leaves)


def _shards(n: int, mesh: Mesh, what: str) -> List[slice]:
    """Contiguous slices of a leading axis of n, one per device."""
    k = mesh.size
    if n % k:
        raise ValueError(f"{n} {what} do not split over a mesh of {k} devices")
    per = n // k
    return [slice(i * per, (i + 1) * per) for i in range(k)]


def make_batched_step(intr: PyramidIntrinsics, cfg: SLAMConfig, levels: int):
    """Returns step(img0 [S, H, W], img1 [S, H, W], template, T_init
    [S, 4, 4]) -> BatchedStepOut for one frame of S sequences; every leaf
    of ``template`` (a TrackerTemplate) has a leading sequence axis.
    Tracking starts from zero affine and unit exposures, and the scale LM
    from 1.0 with the translation x -0.54 of the rig, as in the JAX
    package."""

    def step(img0, img1, template: TrackerTemplate, T_init) -> BatchedStepOut:
        dev = img0.device
        S = img0.shape[0]
        if dev.type == "cuda":
            pyr0 = build_pyramid(img0, levels).data
            pyr1 = build_pyramid(img1, levels).data
            zero = AffLight(0.0, 0.0)
            tr = track_lm_cuda(pyr0, template, intr, cfg, T_init, zero, zero, 1.0, 1.0)
            so = scale_lm_cuda(pyr1, template, torch.ones(S, device=dev), intr, intr,
                               _T10, cfg)
            return BatchedStepOut(T=tr.T, res=tr.res[:, 0], scale=so.scale,
                                  scale_err=so.error)
        z = torch.zeros((), device=dev)
        zero, one = AffLight(z, z), z + 1.0
        outs = []
        for s in range(S):
            tm = TrackerTemplate(*[tuple(x[s] for x in leaf) for leaf in template])
            tr = track_candidate(build_pyramid(img0[s], levels).data, tm, intr, cfg,
                                 T_init[s], zero, zero, one, one)
            so = optimize_scale_single(build_pyramid(img1[s], levels).data, tm, intr, intr,
                                       _T10, cfg, 1.0)
            outs.append(BatchedStepOut(T=tr.T[None], res=tr.res_per_level[0][None],
                                       scale=so.scale[None], scale_err=so.error[None]))
        return _stack(outs, dev)

    return step


def shard_batched_step(step_fn, mesh: Mesh):
    """The batched step with its sequences split over the mesh: each
    device steps its shard, the outputs gathered on the first device."""

    def sharded(img0, img1, template, T_init) -> BatchedStepOut:
        outs = []
        for sl, dev in zip(_shards(img0.shape[0], mesh, "sequences"), mesh.devices):
            on = lambda x: x[sl].to(dev)
            outs.append(step_fn(on(img0), on(img1), _tree(template, on), on(T_init)))
        return _stack(outs, mesh.devices[0])

    return sharded


def shard_ba_optimize(cfg: SLAMConfig, mesh: Mesh, iterations: int = 2):
    """Windowed-BA optimization of a batch of independent windows (a
    BAState with a leading batch axis on every leaf) split over the mesh:
    ``models/ba.optimize`` per window, in order, the windows gathered on
    the first device. Returns step(states) -> (states, rmse [B], ok [B]).
    On the card each window's LM loop is K9-K11 (``csrc/ba.cu``), on the
    CPU the plain loop."""
    from ..models import ba as ba_mod

    def step(states):
        outs = []
        for sl, dev in zip(_shards(states.frame_valid.shape[0], mesh, "windows"),
                           mesh.devices):
            shard = _tree(states, lambda x: x[sl].to(dev))
            for i in range(sl.stop - sl.start):
                st, rmse, ok = ba_mod.optimize(_tree(shard, lambda x: x[i]), cfg, iterations)
                outs.append((_tree(st, lambda x: x[None]), rmse[None], ok[None]))
        return _stack(outs, mesh.devices[0])

    return step


def shard_candidate_retrack(intr: PyramidIntrinsics, cfg: SLAMConfig, mesh: Mesh):
    """ONE sequence's candidate re-track stage (the 78-perturbation batch)
    with the candidates split over the mesh: the pyramid and the template
    go to every device, each tracks its shard (one K2-LM launch on the
    card), and the winner is the masked argmin over the gathered (res,
    ok). Returns step(pyr_new, template, T_cands [C, 4, 4]) -> (res0 [C],
    ok [C], winner [n]): the winner once per device, as the JAX package's
    per-device copies (callers read [0])."""

    def step(pyr_new, template, T_cands):
        res, ok = [], []
        for sl, dev in zip(_shards(T_cands.shape[0], mesh, "candidates"), mesh.devices):
            on = lambda x: x.to(dev)
            z = torch.zeros((), device=dev)
            zero, one = AffLight(z, z), z + 1.0
            out = track_candidates_batch(tuple(on(x) for x in pyr_new), _tree(template, on),
                                         intr, cfg, on(T_cands[sl]), zero, zero, one, one)
            res.append(out.res_per_level[:, 0])
            ok.append(out.ok)
        res0, ok_all = _stack(res, mesh.devices[0]), _stack(ok, mesh.devices[0])
        masked = torch.where(ok_all & torch.isfinite(res0), res0,
                             torch.full_like(res0, float("inf")))
        return res0, ok_all, torch.argmin(masked).expand(mesh.size)

    return step


def shard_scale_grid(intr0: PyramidIntrinsics, intr1: PyramidIntrinsics,
                     cfg: SLAMConfig, mesh: Mesh):
    """The scale-opt guess grid with the guesses split over the mesh (one
    K3-LM launch per device on the card), the best error > 0 chosen from
    the gathered (scale, error). Returns step(pyr1, template, t_cam1_cam0,
    scales0 [G]) -> (scale [n], error [n]), the winner once per device."""

    def step(pyr1, template, t_cam1_cam0, scales0):
        if isinstance(t_cam1_cam0, torch.Tensor):
            t_cam1_cam0 = t_cam1_cam0.cpu().numpy()
        scales0 = torch.as_tensor(scales0, dtype=torch.float32)
        s_all, e_all = [], []
        for sl, dev in zip(_shards(scales0.shape[0], mesh, "guesses"), mesh.devices):
            on = lambda x: x.to(dev)
            out = optimize_scale_batch(tuple(on(x) for x in pyr1), _tree(template, on),
                                       on(scales0[sl]), intr0, intr1, t_cam1_cam0, cfg)
            s_all.append(out.scale)
            e_all.append(out.error)
        s_all, e_all = _stack(s_all, mesh.devices[0]), _stack(e_all, mesh.devices[0])
        best = torch.argmin(torch.where(e_all > 0, e_all, torch.full_like(e_all, float("inf"))))
        return s_all[best].expand(mesh.size), e_all[best].expand(mesh.size)

    return step


def shard_posegraph_optimize(mesh: Mesh, iterations: int = 25, huber_delta: float = 1.0,
                             cg_iters: int = 100):
    """Pose-graph Gauss-Newton with the EDGES split over the mesh: node
    poses on every device, each shard linearizes its edges and adds its
    partial gradient, block-Jacobi diagonal and Hessian-vector products
    into the full node vectors, summed over the shards in device order on
    the first device (the JAX package's ``psum``) in every CG matvec.
    Returns step(data: PoseGraphData) -> [N, 4, 4]; the edge arrays are
    padded to a multiple of the mesh size. One shard is the same system
    with the same damping as ``loop/pose_graph.optimize``'s CG solver: it
    runs there (on the card K6 -> K8 per iteration, no host read, the same
    bits on two runs)."""
    from ..loop import pose_graph as pg

    def step(data):
        if mesh.size == 1:
            on = _tree(data, lambda x: x.to(mesh.devices[0]))
            return pg.optimize(on, iterations, huber_delta, "cg", cg_iters).to(data.T_wc.device)
        T = data.T_wc
        N = T.shape[0]
        home = T.device
        free = pg._free_mask(data).to(torch.float32)[:, None]
        slices = _shards(data.edge_a.shape[0], mesh, "edges")
        for _ in range(iterations):
            shards = []
            for sl, dev in zip(slices, mesh.devices):
                local = pg.PoseGraphData(
                    T_wc=T.to(dev), node_valid=data.node_valid.to(dev),
                    edge_a=data.edge_a[sl].to(dev), edge_b=data.edge_b[sl].to(dev),
                    edge_Z=data.edge_Z[sl].to(dev), edge_w_t=data.edge_w_t[sl].to(dev),
                    edge_w_r=data.edge_w_r[sl].to(dev), edge_valid=data.edge_valid[sl].to(dev),
                    fixed_node=data.fixed_node)
                shards.append((local, *pg.edge_system(local, local.T_wc, huber_delta)))

            def psum(part):
                """part(shard's data, Hblk, bblk) [N, ...] of every shard,
                summed on the first device in device order."""
                total = None
                for sh in shards:
                    y = part(*sh).to(home)
                    total = y if total is None else total + y
                return total

            b = -psum(lambda d, H, g: pg._scatter_b(d, g, N)) * free
            D = psum(lambda d, H, g: pg._edge_diag(d.edge_a, d.edge_b, H, N))
            edge_Hx = lambda x: psum(lambda d, H, g: pg._edge_Hx(d.edge_a, d.edge_b, H,
                                                                  x.to(H.device)))
            x = pg._pcg(b, edge_Hx, D, free, 1e-4 + 1e-6, cg_iters)
            T = T @ lie.se3_exp(x)
        return T

    return step
