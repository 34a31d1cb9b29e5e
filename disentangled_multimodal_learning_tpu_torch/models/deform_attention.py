"""2-D and 1-D deformable cross attention with the CPB bias (counterpart
of ``disentangled_multimodal_learning_tpu/models/deform_attention.py``:
``CPB`` :166, ``DeformCrossAttention2D`` :382 and
``DeformCrossAttention1D`` :566).

The port runs the kv-major **"kn"** attention layout ``[B, H, K, N]`` that
the TPU runs: the CPB bias comes out of its kernel in that layout, and
sim, softmax (over K) and PV consume it with no transpose.

Parameter names and shapes follow the reference state_dict that
``utils/torch_export.py`` writes (2-D: grouped 1x1 convs ``[out, in/G, 1,
1]``, the depthwise offset conv ``[od, 1, k, k]``; 1-D: ungrouped 1x1
conv1ds ``[out, in, 1]``, the depthwise offset conv ``[od, 1, k]``; the CPB
MLP as ``mlp.{0.0,1.0,2}``), so exported JAX weights load with
``strict=True``.

Dtype policy (JAX ``:38-42``, ``:534-545``, ``:664-680``): on the card
with ``attn_bf16_streams`` both attention matmuls take bf16 operands and the
``[B, H, K, N]`` sim / attention streams are stored in bf16, while the
softmax upcasts and reduces in f32; the 2-D module's grouped q/k/v
projections take bf16 operands too (the 1-D module's ungrouped ones stay
f32, as JAX's ``nn.Dense`` there has no dtype).  With ``cpb_table_bf16`` the
2-D table CPB (K1, K5) stores its windows in bf16 on the card (the blend
stays f32; JAX's ``TBL_BF16_OUT``).  Everywhere else (and always on the
CPU) everything is f32.  The fused table attention
(``fused_table_attention``, kernel K6) takes q, k and v in f32 and returns
an f32 map whatever the stream dtypes, as in JAX.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import cpb as cpb_ops
from ..ops import cpb1d as cpb1d_ops
from ..ops import fused_table as fused_ops


class PointwiseConv(nn.Module):
    """1x1 conv, optionally grouped, applied to channels-last tokens
    ``[..., in] -> [..., out]``.  Holds the reference's Conv2d weight
    ``[out, in/groups, 1, 1]`` (Conv1d ``[out, in/groups, 1]`` with
    ``conv1d``); computes as a (block-diagonal) matmul, so the tokens never
    go through NCHW."""

    def __init__(self, in_features: int, out_features: int, groups: int = 1,
                 bias: bool = False, conv1d: bool = False):
        super().__init__()
        self.groups = groups
        kernel = (1,) if conv1d else (1, 1)
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features // groups, *kernel))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x, dtype: torch.dtype | None = None):
        w = self.weight.flatten(1)
        if dtype is not None:
            x, w = x.to(dtype), w.to(dtype)
        if self.groups == 1:
            y = F.linear(x, w)
        else:
            g = self.groups
            y = torch.einsum("...gi,goi->...go", x.unflatten(-1, (g, -1)),
                             w.unflatten(0, (g, -1))).flatten(-2)
        y = y.float()
        return y if self.bias is None else y + self.bias


class Scale(nn.Module):
    def __init__(self, scale: float):
        super().__init__()
        self.scale = scale

    def forward(self, x):
        return x * self.scale


class CPB(nn.Module):
    """SwinV2 continuous position bias MLP (``coords`` -> dim -> dim ->
    heads/groups, relu; ``coords`` 2 for the 2-D module, 1 for the 1-D).
    :meth:`forward` returns the kv-major bias ``[B, H, K, N]``: in 2-D
    with one output channel (``heads == offset_groups``) through the table
    kernel K1 at ``table_divisor == 1`` and K5 at ``table_divisor >= 2``
    (JAX's ``use_table`` gate, ``:223-226``); in 1-D through the 1-D table
    kernel K4 at any ``table_divisor > 0`` (the 1-D lattice always has the
    query spacing, JAX ``:190-195``); through the exact kernel K2 at 0 (and
    in 2-D with several channels), the 1-D coordinate padded with a zero
    second one and a zero row of ``w1`` (JAX ``:285-298``).
    :meth:`table_parts` hands the fused table attention its divisor-1
    table and shifts instead (JAX ``table_parts=True``)."""

    def __init__(self, dim: int, heads: int, offset_groups: int,
                 coords: int = 2):
        super().__init__()
        self.heads = heads
        self.offset_groups = offset_groups
        self.mlp = nn.Sequential(
            nn.Sequential(nn.Linear(coords, dim), nn.ReLU()),
            nn.Sequential(nn.Linear(dim, dim), nn.ReLU()),
            nn.Linear(dim, heads // offset_groups))

    def weights(self):
        """MLP weights in the kernels' (JAX) layout: w [in, out], b [out]."""
        l1, l2, l3 = self.mlp[0][0], self.mlp[1][0], self.mlp[2]
        return (l1.weight.t().contiguous(), l1.bias, l2.weight.t().contiguous(),
                l2.bias, l3.weight.t().contiguous(), l3.bias)

    def table_parts(self, grid_kv, *, side: int, kv_bound: float):
        """``grid_kv [B*G, K, 2]`` -> the divisor-1 ``table [tn, tn]`` and
        the rows' lattice ``shifts [B*G*K, 2]``, both differentiable."""
        w = self.weights()
        return (cpb_ops.cpb_table(*w, side=side, kv_bound=kv_bound),
                cpb_ops.table_shifts(grid_kv, side=side, kv_bound=kv_bound))

    def forward(self, grid_q, grid_kv, *, side: int, table_divisor: int,
                kv_bound: float, out_dtype=torch.float32):
        """``grid_q [N, P]``, ``grid_kv [B*G, K, P]`` -> ``[B, H, K, N]``
        (``side`` is the 2-D grid's side; the 1-D table needs none); the
        2-D table stores ``out_dtype``, every other path f32."""
        bg, k, P = grid_kv.shape
        b = bg // self.offset_groups
        w = self.weights()
        if P == 1 and table_divisor > 0:
            bias = cpb1d_ops.cpb_bias_table_1d(
                grid_kv[..., 0], *w, n_q=grid_q.shape[0], kv_bound=kv_bound)
        elif P == 1:
            bias = cpb_ops.cpb_bias_transposed(
                F.pad(grid_q, (0, 1)), F.pad(grid_kv, (0, 1)),
                torch.cat([w[0], torch.zeros_like(w[0])]), *w[1:])
        elif table_divisor > 0 and w[4].shape[1] == 1:
            bias = cpb_ops.cpb_bias_table(grid_kv, *w, side=side,
                                          kv_bound=kv_bound,
                                          divisor=table_divisor,
                                          out_dtype=out_dtype)
        else:
            bias = cpb_ops.cpb_bias_transposed(grid_q, grid_kv, *w)
        # head = g * (heads/groups) + o, as in the JAX module
        return bias.reshape(b, self.heads, k, grid_q.shape[0])


def normalized_grid(h: int, w: int, device=None):
    """``[h, w, 2]`` (x, y) pixel grid scaled to [-1, 1] per axis
    (``create_grid_2d`` + ``normalize_grid_2d``: x by ``w-1``, y by ``h-1``)."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device),
                            indexing="ij")
    return torch.stack([xs * (2.0 / max(w - 1, 1)) - 1.0,
                        ys * (2.0 / max(h - 1, 1)) - 1.0], dim=-1)


class DeformCrossAttention2D(nn.Module):
    """x1 queries, x2 sampled as kv on a deformed ``gh x gw`` grid
    (``deform_attention.py:382``).  Inputs ``[B, N, C]`` with N a perfect
    square; returns ``(out [B, N, C], attn [B, H, K, N])``.  In train mode
    the attention weights go through ``dropout`` before PV; the returned
    map is the one before dropout (JAX ``attn_return``, :541-542), which is
    what the attention consistency loss reads.

    ``fused_table_attention`` runs the fused table attention (kernel K6:
    bias windows, sim, softmax, dropout and PV in one kernel, JAX ``:494-526``)
    where JAX's gate holds: divisor 1, a deformed grid of more than one
    point a side, ``heads == offset_groups``; elsewhere the module runs the
    unfused path.  JAX's further ``v10_supported`` condition is a TPU layout
    rule that the card's kernel does not have."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8,
                 dropout: float = 0.0, downsample_factor: int = 4,
                 offset_scale: float = 4.0, offset_groups: int = 8,
                 offset_kernel_size: int = 6, cpb_table_divisor: int = 0,
                 attn_bf16_streams: bool = False,
                 fused_table_attention: bool = False,
                 cpb_table_bf16: bool = False):
        super().__init__()
        inner = dim_head * heads
        od = inner // offset_groups
        self.dim_head, self.heads, self.offset_groups = dim_head, heads, offset_groups
        self.dropout = dropout
        self.offset_scale = offset_scale
        self.cpb_table_divisor = cpb_table_divisor
        self.attn_bf16_streams = attn_bf16_streams
        self.fused_table_attention = fused_table_attention
        self.cpb_table_bf16 = cpb_table_bf16
        self.to_q = PointwiseConv(dim, inner, groups=offset_groups)
        self.to_k = PointwiseConv(dim, inner, groups=offset_groups)
        self.to_v = PointwiseConv(dim, inner, groups=offset_groups)
        pad = (offset_kernel_size - downsample_factor) // 2
        self.to_offsets = nn.Sequential(
            nn.Conv2d(od, od, offset_kernel_size, stride=downsample_factor,
                      padding=pad, groups=od),
            nn.GELU(),
            nn.Conv2d(od, 2, 1, bias=False),
            nn.Tanh(),
            Scale(offset_scale))
        self.rel_pos_bias = CPB(dim // 4, heads, offset_groups)
        self.to_out = PointwiseConv(inner, dim, bias=True)

    def forward(self, x1, x2, return_vgrid: bool = False):
        B, N, C = x1.shape
        side = math.isqrt(N)
        if side * side != N:
            raise ValueError(f"token count {N} must be a perfect square")
        G, H, dh = self.offset_groups, self.heads, self.dim_head
        low = self.attn_bf16_streams and x1.is_cuda
        cdt = torch.bfloat16 if low else None  # matmul operand dtype
        sdt = torch.bfloat16 if low else torch.float32  # sim / attn streams

        q = self.to_q(x1, cdt)                                   # [B, N, inner]
        # offsets: the depthwise conv is shared by the G groups, so the
        # groups fold into the batch ([B*G, od, side, side])
        qg = q.reshape(B, side, side, G, -1).permute(0, 3, 4, 1, 2)
        off = self.to_offsets(qg.reshape(B * G, -1, side, side))  # [B*G,2,gh,gw]
        gh, gw = off.shape[-2:]
        # vgrid normalized by the SMALL grid extent, as in the reference
        base = torch.stack(torch.meshgrid(
            torch.arange(gw, dtype=off.dtype, device=off.device),
            torch.arange(gh, dtype=off.dtype, device=off.device),
            indexing="xy"))                                      # [2, gh, gw]
        vgrid = base + off
        pts = torch.stack([vgrid[:, 0] * (2.0 / max(gw - 1, 1)) - 1.0,
                           vgrid[:, 1] * (2.0 / max(gh - 1, 1)) - 1.0],
                          dim=-1)                                # [B*G,gh,gw,2]

        x2g = x2.reshape(B, side, side, G, -1).permute(0, 3, 4, 1, 2)
        kv = F.grid_sample(x2g.reshape(B * G, -1, side, side), pts,
                           mode="bilinear", padding_mode="zeros",
                           align_corners=False)                  # [B*G,cg,gh,gw]
        K = gh * gw
        kv = kv.reshape(B, G, -1, K).permute(0, 3, 1, 2).reshape(B, K, C)
        k = self.to_k(kv, cdt)
        v = self.to_v(kv, cdt)

        def split(t):
            return t.reshape(B, -1, H, dh).transpose(1, 2)       # [B,H,L,dh]

        qh = split(q) * dh ** -0.5
        kh, vh = split(k), split(v)
        divisor = self.cpb_table_divisor if min(gh, gw) > 1 else 0
        kv_bound = cpb_ops.kv_bound_2d(self.offset_scale, gh, gw)
        if self.fused_table_attention and divisor == 1 and H == G:
            table, shifts = self.rel_pos_bias.table_parts(
                pts.reshape(B * G, K, 2), side=side, kv_bound=kv_bound)
            rate = self.dropout if self.training else 0.0
            # the mask's seed, from torch's RNG (JAX: make_rng("dropout"))
            seed = int(torch.randint(0, 2 ** 31 - 1, ())) if rate > 0 else 0
            # q, k and v are f32 here (the projections return f32)
            out, attn = fused_ops.fused_table_attention(
                qh.reshape(B * H, N, dh), kh.reshape(B * H, K, dh),
                vh.reshape(B * H, K, dh), table, shifts, side, seed, rate)
            out = out.reshape(B, H, N, dh).transpose(1, 2).reshape(B, N, H * dh)
            return (self.to_out(out),
                    vgrid if return_vgrid else attn.reshape(B, H, K, N))
        grid_q = normalized_grid(side, side, x1.device).reshape(N, 2)
        bias = self.rel_pos_bias(
            grid_q, pts.reshape(B * G, K, 2), side=side, table_divisor=divisor,
            kv_bound=kv_bound,
            out_dtype=(torch.bfloat16 if self.cpb_table_bf16 and x1.is_cuda
                       else torch.float32))
        opd = cdt or torch.float32
        sim = torch.matmul(kh.to(opd), qh.to(opd).transpose(-1, -2)).to(sdt)
        sim = sim + bias.to(sdt)                                 # [B,H,K,N]
        attn = torch.softmax(sim.float(), dim=-2).to(sdt)
        dropped = F.dropout(attn, self.dropout, self.training)
        out = torch.matmul(dropped.transpose(-1, -2).to(opd),
                           vh.to(opd)).float()
        out = out.transpose(1, 2).reshape(B, N, H * dh)
        return self.to_out(out), (vgrid if return_vgrid else attn)


class DeformCrossAttention1D(nn.Module):
    """x1 queries, x2 sampled as kv at ``n_ds`` deformed positions along the
    sequence (``deform_attention.py:566``; the reference instantiates it
    with dim 128, downsample 4, offset scale 2, kernel 6, 4 offset groups
    and ungrouped q/k/v).  Inputs ``[B, N, C]``; returns ``out [B, N, C]``.
    No attention map leaves the module, as in JAX.

    ``degenerate_sampling`` reproduces the reference's pad-to-2-D
    ``grid_sample`` (JAX ``grid_sample_1d_torchtrick``: the sequence's
    centre token times ``max(1 - |v| / 2, 0)``); the default samples the
    sequence bilinearly (zeros padding, align_corners=False), here
    ``F.grid_sample`` on a ``[B*G, C/G, 1, N]`` image at y = 0.  The CPB
    takes the 1-D table (K4) at any ``cpb_table_divisor > 0`` and the exact
    MLP (K2) at 0."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8,
                 dropout: float = 0.0, downsample_factor: int = 4,
                 offset_scale: float = 2.0, offset_groups: int = 4,
                 offset_kernel_size: int = 6,
                 degenerate_sampling: bool = False, cpb_table_divisor: int = 0,
                 attn_bf16_streams: bool = False):
        super().__init__()
        inner = dim_head * heads
        od = inner // offset_groups
        self.dim_head, self.heads, self.offset_groups = dim_head, heads, offset_groups
        self.dropout = dropout
        self.offset_scale = offset_scale
        self.degenerate_sampling = degenerate_sampling
        self.cpb_table_divisor = cpb_table_divisor
        self.attn_bf16_streams = attn_bf16_streams
        self.to_q = PointwiseConv(dim, inner, conv1d=True)
        self.to_k = PointwiseConv(dim, inner, conv1d=True)
        self.to_v = PointwiseConv(dim, inner, conv1d=True)
        pad = (offset_kernel_size - downsample_factor) // 2
        self.to_offsets = nn.Sequential(
            nn.Conv1d(od, od, offset_kernel_size, stride=downsample_factor,
                      padding=pad, groups=od),
            nn.GELU(),
            nn.Conv1d(od, 1, 1, bias=False),
            nn.Tanh(),
            Scale(offset_scale))
        self.rel_pos_bias = CPB(dim // 4, heads, offset_groups, coords=1)
        self.to_out = PointwiseConv(inner, dim, bias=True, conv1d=True)

    def forward(self, x1, x2):
        B, N, C = x1.shape
        G, H, dh = self.offset_groups, self.heads, self.dim_head
        low = self.attn_bf16_streams and x1.is_cuda
        # the attention's matmul operands and its sim / attn streams
        sdt = torch.bfloat16 if low else torch.float32

        q = self.to_q(x1)                                        # [B, N, inner]
        # offsets: the depthwise conv is shared by the G groups, so the
        # groups fold into the batch ([B*G, od, N])
        qg = q.reshape(B, N, G, -1).permute(0, 2, 3, 1).reshape(B * G, -1, N)
        off = self.to_offsets(qg)[:, 0]                          # [B*G, n_ds]
        n_ds = off.shape[-1]
        vgrid = torch.arange(n_ds, dtype=off.dtype, device=off.device) + off
        pts = 2.0 * vgrid / max(n_ds - 1, 1) - 1.0               # [B*G, n_ds]

        x2g = x2.reshape(B, N, G, -1).permute(0, 2, 1, 3).reshape(B * G, N, -1)
        if self.degenerate_sampling:
            mid = (N - 1) // 2
            center = (x2g[:, mid] if N % 2 else
                      0.5 * (x2g[:, N // 2 - 1] + x2g[:, N // 2]))
            gain = torch.clamp(1.0 - pts.abs() * 0.5, min=0.0)
            kv = center[:, None, :] * gain[..., None]            # [B*G,n_ds,cg]
        else:
            grid = torch.stack([pts, torch.zeros_like(pts)], dim=-1)
            kv = F.grid_sample(x2g.transpose(1, 2)[:, :, None, :],
                               grid[:, None], mode="bilinear",
                               padding_mode="zeros", align_corners=False)
            kv = kv[:, :, 0].transpose(1, 2)                     # [B*G,n_ds,cg]
        kv = kv.reshape(B, G, n_ds, -1).transpose(1, 2).reshape(B, n_ds, C)
        k = self.to_k(kv)
        v = self.to_v(kv)

        def split(t):
            return t.reshape(B, -1, H, dh).transpose(1, 2)       # [B,H,L,dh]

        qh = split(q) * dh ** -0.5
        kh, vh = split(k), split(v)
        seq = torch.arange(N, dtype=torch.float32, device=x1.device)
        grid_q = (2.0 * seq / max(N - 1, 1) - 1.0)[:, None]      # [N, 1]
        # |pts| <= 1 + 2 * offset_scale / (n_ds - 1): tanh-bounded offsets
        # normalized by the downsampled extent
        kv_bound = 1.0 + 2.0 * self.offset_scale / (n_ds - 1) if n_ds > 1 else 0.0
        bias = self.rel_pos_bias(
            grid_q, pts[..., None], side=N,
            table_divisor=self.cpb_table_divisor if n_ds > 1 else 0,
            kv_bound=kv_bound)                                   # [B,H,K,N]
        sim = torch.matmul(kh.to(sdt), qh.to(sdt).transpose(-1, -2))
        sim = sim + bias.to(sdt)
        attn = torch.softmax(sim.float(), dim=-2).to(sdt)
        attn = F.dropout(attn, self.dropout, self.training)
        out = torch.matmul(attn.transpose(-1, -2), vh.to(sdt)).float()
        return self.to_out(out.transpose(1, 2).reshape(B, N, H * dh))
