"""Carry state between the JAX package and the port.

The SLAM system has no weights; its state is NamedTuples of arrays. The
JAX package's NamedTuples, pulled to the host as numpy arrays (with
``jax.device_get``), convert field by field into the port's NamedTuples
of the same name and fields (``to_torch``), and back into numpy
(``to_numpy``). Covered: ``TrackerTemplate``, ``Pyramid``, ``BAState``,
``ImmaturePoints``, ``PyramidIntrinsics``, ``PoseGraphData``,
``LoopPoseResult``, ``AffLight`` and ``MonoInitState``; nested tuples
convert element-wise.
The ``MarginalizedKF`` dataclass converts too: its pyramid tuple becomes
tensors, its host fields (poses, points, colours, errors) stay numpy and
Python numbers, as both packages keep them.

Index fields (``BAState.p_host``, the pose graph's edge ends and fixed
node, the mono bootstrap's per-level ``knn`` and ``parent``) are int64
in the port, where they index tensors, and int32 as in the JAX package
on the way back.

``config_from_jax`` rebuilds a ``SLAMConfig`` of the JAX package as the
port's own (its copy in ``config.py``), field by field, so a test can
hand both packages the same configuration.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import config as port_config
from ..geometry.camera import PyramidIntrinsics
from ..loop.pose_estimator import LoopPoseResult
from ..loop.pose_graph import PoseGraphData
from ..models.ba import BAState
from ..models.depth_template import TrackerTemplate
from ..models.frontend import MarginalizedKF
from ..models.immature import ImmaturePoints
from ..models.mono_init import MonoInitState
from ..models.tracker import AffLight
from ..ops.pyramid import Pyramid

PORT_TYPES = {cls.__name__: cls for cls in
              (TrackerTemplate, Pyramid, BAState, ImmaturePoints, PyramidIntrinsics,
               PoseGraphData, LoopPoseResult, AffLight, MarginalizedKF,
               MonoInitState)}
INDEX_FIELDS = {"p_host", "edge_a", "edge_b", "fixed_node", "knn", "parent"}


def _index(x, cast):
    """An index field (or a tuple of them, one per level) cast."""
    return type(x)(cast(a) for a in x) if isinstance(x, tuple) else cast(x)


def _convert_mkf(mkf, cls, convert):
    """A MarginalizedKF of either package as ``cls``, its pyramid converted."""
    vals = {f.name: getattr(mkf, f.name) for f in dataclasses.fields(mkf)}
    if vals["pyr"] is not None:
        vals["pyr"] = tuple(convert(p) for p in vals["pyr"])
    return cls(**vals)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def to_torch(tree, device="cpu"):
    """numpy (or array-like) leaves -> tensors on ``device``; known
    NamedTuples -> the port's class of the same name."""
    if type(tree).__name__ == "MarginalizedKF":
        return _convert_mkf(tree, MarginalizedKF, lambda p: to_torch(p, device))
    if _is_namedtuple(tree):
        cls = PORT_TYPES.get(type(tree).__name__, type(tree))
        if cls is PyramidIntrinsics:
            return PyramidIntrinsics(*tree)           # static host tuples
        vals = []
        for name, v in zip(tree._fields, tree):
            t = to_torch(v, device)
            if name in INDEX_FIELDS:
                t = _index(t, lambda a: a.to(torch.int64))
            vals.append(t)
        return cls(*vals)
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_torch(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, (int, float, bool)) or tree is None:
        return tree
    return torch.as_tensor(np.array(tree), device=device)


def to_numpy(tree):
    """Tensor leaves -> numpy; NamedTuples keep their (port) class."""
    if type(tree).__name__ == "MarginalizedKF":
        return _convert_mkf(tree, type(tree), to_numpy)
    if _is_namedtuple(tree):
        if isinstance(tree, PyramidIntrinsics):
            return tree
        vals = []
        for name, v in zip(tree._fields, tree):
            a = to_numpy(v)
            if name in INDEX_FIELDS:
                a = _index(a, lambda x: x.astype(np.int32))
            vals.append(a)
        return type(tree)(*vals)
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def config_from_jax(cfg):
    """A configuration dataclass tree of the JAX package as the port's
    classes of the same names (any dataclass field recurses)."""
    if not dataclasses.is_dataclass(cfg):
        return cfg
    cls = getattr(port_config, type(cfg).__name__)
    return cls(**{f.name: config_from_jax(getattr(cfg, f.name))
                  for f in dataclasses.fields(cfg)})
