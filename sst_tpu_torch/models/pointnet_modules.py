"""PointNet++ set abstraction and feature propagation, and PAConv
(counterpart of ``sst_tpu/models/pointnet_modules.py``; the reference's
``PointSAModuleMSG``, ``PointSAModule``, ``PointFPModule``, ``ScoreNet``
and ``PAConv``).

Batched static shapes [B, N, ...] with optional validity masks (padding
rows are never grouped: ``ops/pointnet.py`` pushes their distances to
1e10); sampling is ``ops/fps.py furthest_point_sample`` per sample,
grouping ``ball_query`` or ``knn``. None of these is a kernel of ours.

The torch modules keep flax's names and layouts, so ``convert.py`` loads a
flax tree into them: a shared MLP is ``layer{i}`` (a bias-free Dense over
the channel axis) and ``bn{i}``; the SA module's MLPs are ``mlp{i}``, the
FP module's ``_SharedMLP_0``, PAConv's ``scorenet`` (its MLP
``_SharedMLP_0``), ``weight_bank`` (a bare [Cin * mul, M * Cout]
parameter, as flax keeps it) and ``bn``. Their batch norms are flax's
``BatchNorm(momentum=0.9, epsilon=1e-5)``: momentum 0.9 where the rest of
the package uses 0.99. The JAX modules infer their input widths; here the
constructors take them (``in_channels``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from sst_tpu_torch.models.layers import BatchNorm, Dense
from sst_tpu_torch.ops.fps import furthest_point_sample
from sst_tpu_torch.ops.pointnet import (
    ball_query,
    grouping_operation,
    knn,
    query_and_group,
    three_interpolate,
    three_nn,
)


class _BatchNorm(BatchNorm):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over dim 1."""

    momentum = 0.9

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5)


class _SharedMLP(nn.Module):
    """1x1 conv + BN + ReLU stack over channel-first [B, C, N, K] maps (the
    reference's ConvModule chains); the last BN and ReLU are optional."""

    def __init__(self, in_channels: int, channels: Sequence[int],
                 last_act: bool = True, last_bn: bool = True):
        super().__init__()
        self.channels = tuple(channels)
        self.last_act = last_act
        self.last_bn = last_bn
        n = len(self.channels)
        c = in_channels
        for i, out in enumerate(self.channels):
            self.add_module(f"layer{i}", Dense(c, out, bias=False))
            if i != n - 1 or last_bn:
                self.add_module(f"bn{i}", _BatchNorm(out))
            c = out

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        n = len(self.channels)
        for i in range(n):
            last = i == n - 1
            x = getattr(self, f"layer{i}")(x.movedim(1, -1)).movedim(-1, 1)
            if not last or self.last_bn:
                x = getattr(self, f"bn{i}")(x, train)
            if not last or self.last_act:
                x = torch.relu(x)
        return x


class PointSAModuleMSG(nn.Module):
    """Multi-scale-grouping set abstraction.

    ``forward(points_xyz [B, N, 3], features [B, C, N] or None, valid
    [B, N], target_xyz, train)`` returns (new_xyz [B, num_point, 3],
    new_features [B, sum(mlp[-1]), num_point], indices [B, num_point]
    int32, None where ``target_xyz`` gave the centres). ``in_channels`` is
    C (0 without features)."""

    def __init__(self, num_point: int, radii: Sequence[Optional[float]],
                 sample_nums: Sequence[int],
                 mlp_channels: Sequence[Sequence[int]], in_channels: int = 0,
                 use_xyz: bool = True, pool_mod: str = "max",
                 normalize_xyz: bool = False, min_radii: Sequence[float] = (),
                 grouper: str = "ball"):
        super().__init__()
        if pool_mod not in ("max", "avg"):
            raise ValueError(f"pool_mod={pool_mod!r}")
        self.num_point = num_point
        self.radii = tuple(radii)
        self.sample_nums = tuple(sample_nums)
        self.use_xyz = use_xyz
        self.pool_mod = pool_mod
        self.normalize_xyz = normalize_xyz
        self.min_radii = tuple(min_radii)
        self.grouper = grouper
        c_in = in_channels + (3 if use_xyz else 0)
        for i, ch in enumerate(mlp_channels):
            self.add_module(f"mlp{i}", _SharedMLP(c_in, ch))
        self.out_channels = sum(ch[-1] for ch in mlp_channels)

    def forward(self, points_xyz: torch.Tensor,
                features: torch.Tensor | None = None,
                valid: torch.Tensor | None = None,
                target_xyz: torch.Tensor | None = None,
                train: bool = False):
        b, n, _ = points_xyz.shape
        if valid is None:
            valid = torch.ones((b, n), dtype=torch.bool,
                               device=points_xyz.device)
        if target_xyz is not None:
            new_xyz, indices = target_xyz, None
        else:
            # D-FPS per sample; the picks carry no gradient
            with torch.no_grad():
                indices = torch.stack([
                    furthest_point_sample(points_xyz[i], valid[i],
                                          self.num_point)[0]
                    for i in range(b)])
            new_xyz = torch.gather(
                points_xyz, 1,
                indices.long()[..., None].expand(-1, -1, 3))
        outs = []
        for i, (radius, ns) in enumerate(zip(self.radii, self.sample_nums)):
            with torch.no_grad():
                if self.grouper == "knn" or radius is None:
                    idx = knn(ns, points_xyz, new_xyz, valid).transpose(1, 2)
                else:
                    lo = self.min_radii[i] if i < len(self.min_radii) else 0.0
                    idx = ball_query(lo, radius, ns, points_xyz, new_xyz,
                                     valid)
            if self.use_xyz:
                grouped = query_and_group(points_xyz, new_xyz, idx,
                                          features=features,
                                          normalize_xyz=self.normalize_xyz,
                                          radius=radius)
            else:
                if features is None:
                    raise ValueError("use_xyz=False needs features")
                grouped = grouping_operation(features, idx)
            out = getattr(self, f"mlp{i}")(grouped, train)
            outs.append(out.amax(-1) if self.pool_mod == "max"
                        else out.mean(-1))
        return new_xyz, torch.cat(outs, dim=1), indices


class PointSAModule(PointSAModuleMSG):
    """Single-scale grouping: one-element radii, sample_nums and
    mlp_channels."""


class PointFPModule(nn.Module):
    """Feature propagation: inverse-distance interpolation of the 3 nearest
    source points, concatenated with the target's features, then a shared
    MLP. ``in_channels`` is the source's C plus the target's C."""

    def __init__(self, mlp_channels: Sequence[int], in_channels: int):
        super().__init__()
        self._SharedMLP_0 = _SharedMLP(in_channels, mlp_channels)
        self.out_channels = tuple(mlp_channels)[-1]

    def forward(self, target: torch.Tensor, source: torch.Tensor | None,
                target_feats: torch.Tensor | None,
                source_feats: torch.Tensor,
                source_valid: torch.Tensor | None = None,
                train: bool = False) -> torch.Tensor:
        if source is not None:
            # the distances differentiate, as JAX's autodiff takes them
            dist, idx = three_nn(target, source, source_valid)
            recip = 1.0 / (dist + 1e-8)
            weight = recip / recip.sum(-1, keepdim=True)
            interp = three_interpolate(source_feats, idx, weight)
        else:
            interp = source_feats.expand(source_feats.shape[:2]
                                         + (target.shape[1],))
        new = (interp if target_feats is None
               else torch.cat([interp, target_feats], dim=1))
        return self._SharedMLP_0(new[..., None], train)[..., 0]


class ScoreNet(nn.Module):
    """An MLP scoring point-pair geometry [B, C, N, K] into per-kernel
    weights [B, N, K, M] (softmax or sigmoid over the M kernels)."""

    def __init__(self, in_channels: int, mlp_channels: Sequence[int],
                 score_norm: str = "softmax", temp_factor: float = 1.0,
                 last_bn: bool = False):
        super().__init__()
        self._SharedMLP_0 = _SharedMLP(in_channels, mlp_channels,
                                       last_act=False, last_bn=last_bn)
        self.score_norm = score_norm
        self.temp_factor = temp_factor

    def forward(self, xyz_features: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        scores = self._SharedMLP_0(xyz_features, train)  # [B, M, N, K]
        if self.score_norm == "softmax":
            scores = torch.softmax(scores / self.temp_factor, dim=1)
        elif self.score_norm == "sigmoid":
            scores = torch.sigmoid(scores / self.temp_factor)
        return scores.permute(0, 2, 3, 1)


class PAConv(nn.Module):
    """Position-adaptive convolution: a weight bank of ``num_kernels``
    kernels mixed per point pair by ScoreNet's scores, then BN and ReLU.
    ``forward((features [B, in_c, npoint, K], points_xyz [B, 3, npoint,
    K]))`` returns (new_features [B, out_c, npoint, K], points_xyz), so
    instances chain as the reference's ``nn.Sequential`` does."""

    def __init__(self, in_channels: int, out_channels: int, num_kernels: int,
                 scorenet_input: str = "w_neighbor_dist",
                 kernel_input: str = "w_neighbor",
                 scorenet_mid: Sequence[int] = (16, 16),
                 score_norm: str = "softmax"):
        super().__init__()
        self.kernel_input = kernel_input
        self.scorenet_input = scorenet_input
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.num_kernels = num_kernels
        kernel_mul = {"identity": 1, "w_neighbor": 2}[kernel_input]
        sc_in = {"identity": 3, "w_neighbor": 6,
                 "w_neighbor_dist": 7}[scorenet_input]
        self.scorenet = ScoreNet(sc_in, (*scorenet_mid, num_kernels),
                                 score_norm=score_norm)
        # flax's kaiming_normal on [fan_in, fan_out]: std sqrt(2 / fan_in)
        fan_in = in_channels * kernel_mul
        self.weight_bank = nn.Parameter(
            torch.randn(fan_in, num_kernels * out_channels)
            * math.sqrt(2.0 / fan_in))
        self.bn = _BatchNorm(out_channels)

    def forward(self, inputs, train: bool = False):
        features, points_xyz = inputs
        if self.kernel_input == "w_neighbor":
            center = features[..., :1]
            features = torch.cat([features - center, features], dim=1)
        center_xyz = points_xyz[..., :1].expand(points_xyz.shape)
        diff = points_xyz - center_xyz
        if self.scorenet_input == "identity":
            xyz_feat = diff
        elif self.scorenet_input == "w_neighbor":
            xyz_feat = torch.cat([diff, points_xyz], 1)
        else:  # w_neighbor_dist
            dist = diff.square().sum(1, keepdim=True).sqrt()
            xyz_feat = torch.cat([center_xyz, diff, dist], 1)
        scores = self.scorenet(xyz_feat, train)  # [B, np, K, M]
        w = self.weight_bank.reshape(self.weight_bank.shape[0],
                                     self.num_kernels, self.out_channels)
        new = torch.einsum("bcnk,cmo,bnkm->bonk", features, w, scores)
        return torch.relu(self.bn(new, train)), points_xyz
