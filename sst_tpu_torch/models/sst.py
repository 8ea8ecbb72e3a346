"""SST backbone: windowed multi-head attention over bucketed dense windows
(counterpart of ``sst_tpu/models/sst.py``).

Submodules keep flax's names (``qk_proj``, ``v_proj``, ``out_proj``,
``WindowAttention_0``, ``LayerNorm_0/1``, ``Dense_0/1``, ``encoder_{i}``,
``block_{i}``, ``linear0``, ``attached_conv_{i}``) so that
``sst_tpu_torch/convert.py`` maps a flax variable tree onto them name for
name.

The attention of every window bucket is ``ops/window_mha.py window_mha``:
the JAX package's fused Pallas kernel's function (f32 logits of bf16 q and
k, bf16 probabilities into AV) on every device, the hand-written kernel on
the card and its plain twin on the CPU. ``use_pallas`` is accepted and
ignored: the fused kernel is the only path of dot-product attention.
Cosine (Swin-v2) attention, ``cosine=True``, takes the JAX package's
einsum path in torch ops, as JAX never sends it to its Pallas kernel: q
and k L2-normalised in float32 and cast to bf16, bf16 logits divided by
the learnt ``tau`` (one, or one per head with ``non_shared_tau``, clamped
at ``tau_min``), a bf16 softmax and AV.

Every module takes flax's compute ``dtype`` (``models/layers.py``): float32
parameters, products and layer norms' results in ``dtype``. At bfloat16 the
projections' q, k and v reach the kernel as they are and its bfloat16
output stays so through the window-to-flat gather, as in JAX.
``remat_blocks`` rematerialises each ``BasicShiftBlock`` in train mode
(flax's ``nn.remat``, ``utils/remat.py``), as JAX does by default.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from sst_tpu_torch.models.layers import (
    ACTIVATIONS,
    ConvNormAct,
    Dense,
    LayerNorm,
)
from sst_tpu_torch.models.sst_input import SSTPlan
from sst_tpu_torch.ops.window import (
    FlatToWindow,
    flat2window,
    window2flat,
    window_key_padding,
)
from sst_tpu_torch.ops.window_mha import window_mha
from sst_tpu_torch.utils import remat


def _l2_normalised(x: torch.Tensor) -> torch.Tensor:
    """bf16 rows over their float32 L2 norm (at least 1e-6) cast to bf16."""
    norm = torch.linalg.vector_norm(x.float(), dim=-1, keepdim=True)
    return x / torch.clamp(norm, min=1e-6).to(x.dtype)


def cosine_window_attention(q, k, v, pad, nhead: int, tau: torch.Tensor):
    """Swin-v2 cosine attention of one bucket, JAX's einsum path: q, k, v
    [W, T, C] (cast to bf16), pad [W, T] (True = empty key), ``tau``
    [nhead] float32; returns [W, T, C] bf16."""
    w, t, c = q.shape
    dh = c // nhead

    def heads(x):
        return x.to(torch.bfloat16).reshape(w, t, nhead, dh)

    q4, k4, v4 = _l2_normalised(heads(q)), _l2_normalised(heads(k)), heads(v)
    logits = torch.einsum("wthd,wshd->whts", q4, k4)
    logits = logits / tau.to(torch.bfloat16)[None, :, None, None]
    logits = logits + torch.where(pad[:, None, None, :], -1e4, 0.0).to(
        torch.bfloat16)
    # jax.nn.softmax's ops in bf16: exp of the max-shifted logits over
    # their sum
    e = torch.exp(logits - logits.amax(-1, keepdim=True).detach())
    probs = e / e.sum(-1, keepdim=True)
    return torch.einsum("whts,wshd->wthd", probs, v4).reshape(w, t, c)


class WindowAttention(nn.Module):
    """Bucketed windowed MHA. The projections run on the flat [N, C]
    voxels; q and k see ``feat + pos``, v sees ``feat``. ``cosine``: the
    Swin-v2 cosine attention of :func:`cosine_window_attention`, with its
    learnt ``tau`` (flax's ``tau`` parameter, initialised to 1)."""

    def __init__(self, d_model: int, nhead: int, cosine: bool = False,
                 dtype=torch.float32, tau_min: float = 0.01,
                 non_shared_tau: bool = False):
        super().__init__()
        self.d_model = d_model
        self.nhead = nhead
        self.cosine = cosine
        self.tau_min = tau_min
        if cosine:
            self.tau = nn.Parameter(torch.ones(nhead if non_shared_tau
                                               else 1))
        self.qk_proj = Dense(d_model, 2 * d_model, dtype=dtype)
        self.v_proj = Dense(d_model, d_model, dtype=dtype)
        self.out_proj = Dense(d_model, d_model, dtype=dtype)

    def windows(self, feat, pos, f2w: FlatToWindow):
        """Per bucket, the attention's inputs (q, k, v, pad): q, k, v are
        [W, T, C] bf16 column blocks of one windowed [W, T, 3C] buffer,
        pad is [W, T] bool (True = empty slot)."""
        qk = self.qk_proj(feat + pos.to(feat.dtype))
        v = self.v_proj(feat)
        # cast on the flat rows, so the window gather moves bf16
        qkv = torch.cat([qk, v], dim=-1).to(torch.bfloat16)
        return [tuple(qkvw.split(self.d_model, dim=-1)) + (pad,)
                for qkvw, pad in zip(flat2window(qkv, f2w),
                                     window_key_padding(f2w))]

    def forward(self, feat, pos, f2w: FlatToWindow):
        if self.cosine:
            tau = torch.clamp(self.tau.repeat_interleave(
                self.nhead // self.tau.shape[0]), min=self.tau_min)
            outs = [cosine_window_attention(q, k, v, pad, self.nhead, tau)
                    for q, k, v, pad in self.windows(feat, pos, f2w)]
        else:
            outs = [window_mha(q, k, v, pad, self.nhead)
                    for q, k, v, pad in self.windows(feat, pos, f2w)]
        # bf16 through the gather back, then the feature dtype on the flat
        # rows
        flat = window2flat(outs, f2w).to(feat.dtype)
        return self.out_proj(flat)


class EncoderLayer(nn.Module):
    """Transformer encoder layer, post-norm (default) or pre-norm; flax
    LayerNorm eps 1e-6."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 activation: str = "gelu", post_norm: bool = True,
                 cosine: bool = False, dtype=torch.float32):
        super().__init__()
        self.post_norm = post_norm
        self.act = ACTIVATIONS[activation]
        self.WindowAttention_0 = WindowAttention(d_model, nhead, cosine,
                                                 dtype)
        self.LayerNorm_0 = LayerNorm(d_model, eps=1e-6, dtype=dtype)
        self.Dense_0 = Dense(d_model, dim_feedforward, dtype=dtype)
        self.Dense_1 = Dense(dim_feedforward, d_model, dtype=dtype)
        self.LayerNorm_1 = LayerNorm(d_model, eps=1e-6, dtype=dtype)

    def forward(self, src, pos, f2w: FlatToWindow):
        if self.post_norm:
            src = self.LayerNorm_0(src + self.WindowAttention_0(src, pos,
                                                                f2w))
            src2 = self.Dense_1(self.act(self.Dense_0(src)))
            return self.LayerNorm_1(src + src2)
        src = src + self.WindowAttention_0(self.LayerNorm_0(src), pos, f2w)
        src2 = self.Dense_0(self.LayerNorm_1(src))
        return src + self.Dense_1(self.act(src2))


class BasicShiftBlock(nn.Module):
    """Two encoder layers: the unshifted windows, then the shifted ones."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 activation: str = "gelu", cosine: bool = False,
                 dtype=torch.float32):
        super().__init__()
        for i in range(2):
            self.add_module(f"encoder_{i}", EncoderLayer(
                d_model, nhead, dim_feedforward, activation, cosine=cosine,
                dtype=dtype))

    def forward(self, src, plan: SSTPlan):
        for i in range(2):
            src = getattr(self, f"encoder_{i}")(src, plan.pos[i],
                                                plan.f2w[i])
        return src


def recover_bev(voxel_feat, voxel_coords, voxel_valid, batch_size: int,
                output_shape) -> torch.Tensor:
    """Voxel features onto a dense BEV canvas in their dtype: one scatter
    into NHWC rows ``(b * ny + y) * nx + x``, returned as an NCHW view of
    them ([B, C, ny, nx], channels-last strides, no copy)."""
    ny, nx = output_shape
    c = voxel_feat.shape[-1]
    size = batch_size * ny * nx
    flat_idx = (voxel_coords[:, 0] * ny + voxel_coords[:, 2]) * nx \
        + voxel_coords[:, 3]
    flat_idx = torch.where(voxel_valid, flat_idx, size).long()
    canvas = voxel_feat.new_zeros((size + 1, c))
    canvas[flat_idx] = torch.where(voxel_valid[:, None], voxel_feat, 0.0)
    return canvas[:size].reshape(batch_size, ny, nx, c).permute(0, 3, 1, 2)


class SSTv2(nn.Module):
    """Single-stride sparse transformer backbone. Returns (BEV map NCHW,
    surviving-voxel mask), or with ``to_bev=False`` (the voxel features
    [N, C], that mask).

    ``in_channel``: width of the voxel features; with it, ``linear0``
    projects them to ``d_model[0]``, without it they must be that wide.
    ``conv_kwargs``: per attached conv (or one dict for all), its
    ``kernel_size`` and ``dilation``. ``conv_shortcut`` adds each attached
    conv's input to its output where their shapes agree. ``remat_blocks``:
    each block is rematerialised in the backward of a train-mode call.
    ``use_pallas`` is accepted and ignored (the window MHA kernel is the
    only path).
    ``dtype``: the compute dtype of the blocks and the attached convs; the
    voxel features are cast to it first."""

    def __init__(self, d_model: Sequence[int] = (128,) * 6,
                 nhead: Sequence[int] = (8,) * 6, num_blocks: int = 6,
                 dim_feedforward: Sequence[int] = (256,) * 6,
                 activation: str = "gelu", output_shape: tuple = (468, 468),
                 num_attached_conv: int = 3,
                 conv_kwargs: tuple = ({"kernel_size": 3, "dilation": 1},
                                       {"kernel_size": 3, "dilation": 1},
                                       {"kernel_size": 3, "dilation": 2}),
                 conv_out_channel: int = 128, in_channel: int | None = None,
                 to_bev: bool = True, conv_shortcut: bool = False,
                 cosine: bool = False, use_pallas: bool | None = None,
                 remat_blocks: bool = True, dtype=torch.float32):
        super().__init__()
        del use_pallas  # the fused kernel is the only path
        self.d_model = tuple(d_model)
        self.num_blocks = num_blocks
        self.output_shape = tuple(output_shape)
        self.to_bev = to_bev
        self.conv_shortcut = conv_shortcut
        self.remat_blocks = remat_blocks
        self.dtype = dtype
        if in_channel is not None:
            self.linear0 = Dense(in_channel, self.d_model[0], dtype=dtype)
        else:
            self.linear0 = None
        for i in range(num_blocks):
            self.add_module(f"block_{i}", BasicShiftBlock(
                self.d_model[i], nhead[i], dim_feedforward[i], activation,
                cosine=cosine, dtype=dtype))
        c = self.d_model[num_blocks - 1]
        self.num_attached_conv = num_attached_conv if to_bev else 0
        for i in range(self.num_attached_conv):
            kw = conv_kwargs if isinstance(conv_kwargs, dict) \
                else conv_kwargs[i]
            kw = {k: v for k, v in kw.items()
                  if k not in ("padding", "stride")}
            self.add_module(f"attached_conv_{i}", ConvNormAct(
                c, conv_out_channel, act="relu", dtype=dtype, **kw))
            c = conv_out_channel
        self.out_channels = c

    def forward(self, voxel_feats, voxel_coords, plan: SSTPlan,
                batch_size: int, train: bool = False):
        x = voxel_feats.to(self.dtype)
        if self.linear0 is not None:
            x = self.linear0(x)
        for i in range(self.num_blocks):
            block = getattr(self, f"block_{i}")
            if self.remat_blocks and train and torch.is_grad_enabled():
                x = remat.checkpoint(block, x, plan)
            else:
                x = block(x, plan)
        if not self.to_bev:
            return x, plan.valid
        bev = recover_bev(x, voxel_coords, plan.valid, batch_size,
                          self.output_shape)
        for i in range(self.num_attached_conv):
            out = getattr(self, f"attached_conv_{i}")(bev, train)
            bev = out + bev if (self.conv_shortcut
                                and out.shape == bev.shape) else out
        return bev, plan.valid


class SSTv1(SSTv2):
    """SSTv1: under the static window plan its forward is SSTv2's; only the
    defaults differ (two dilation-2 attached convs)."""

    def __init__(self, num_attached_conv: int = 2,
                 conv_kwargs: tuple = ({"kernel_size": 3, "dilation": 2},
                                       {"kernel_size": 3, "dilation": 2}),
                 **kw):
        super().__init__(num_attached_conv=num_attached_conv,
                         conv_kwargs=conv_kwargs, **kw)
