"""Gated bilinear and trilinear Kronecker fusion (counterpart of
``disentangled_multimodal_learning_tpu/models/fusion.py``:
``BilinearFusion`` :23-82, with the flax BatchNorm of its two encoders,
and ``TrilinearFusion`` :85-149, which no factory mode builds)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import mesh


class FlaxBatchNorm1d(nn.Module):
    """BatchNorm over ``[B, C]`` as flax keeps it, not as torch does: in
    train mode it normalises by the batch mean and BIASED variance and
    updates ``running = 0.9 running + 0.1 batch`` with that biased variance
    (flax ``momentum`` 0.9; torch's ``BatchNorm1d`` keeps the unbiased one,
    4/3 of it at B = 4); in eval mode it normalises by the running
    statistics.  eps 1e-5, flax's default.  The statistics are buffers, so
    a checkpoint holds them.  In a data-parallel train step the batch
    statistics span the rows of every rank of the data group
    (``parallel/mesh.py batch_moments``; the reference's SyncBatchNorm,
    JAX's statistics over the global batch)."""

    MOMENTUM, EPS = 0.9, 1e-5

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.EPS)
        group = mesh.batch_group()
        if group is not None:
            mean, var = mesh.batch_moments(x, group)
            self._update(mean.detach(), var.detach())
            return ((x - mean) * torch.rsqrt(var + self.EPS) * self.weight
                    + self.bias)
        with torch.no_grad():
            self._update(x.mean(dim=0), x.var(dim=0, unbiased=False))
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.EPS)

    @torch.no_grad()
    def _update(self, mean, var):
        m = self.MOMENTUM
        self.running_mean.mul_(m).add_((1 - m) * mean)
        self.running_var.mul_(m).add_((1 - m) * var)


class BilinearFusion(nn.Module):
    """Two gated branches (``linear_h``; where the gate is on, a sigmoid of
    ``nn.Bilinear``-shaped ``bilinear_w [dd, dim1, dim2]`` of both vectors,
    or of ``linear_z`` on their concatenation without ``use_bilinear``;
    ``linear_o``), the outer product of the two outputs each with a 1
    appended, ``encoder1`` (Linear, BatchNorm, ReLU, dropout), with
    ``skip`` the two outputs concatenated back, and ``encoder2``.  The
    branch widths are ``dim / scale_dim``.  Dropout ``dropout_rate`` on the
    branch outputs, the product and the encoders' outputs.  (JAX's
    ``use_batchnorm`` is always on: no caller turns it off.)"""

    def __init__(self, skip: int = 1, use_bilinear: int = 1, gate1: int = 1,
                 gate2: int = 1, dim1: int = 32, dim2: int = 32,
                 scale_dim1: int = 1, scale_dim2: int = 1, mmhid: int = 64,
                 dropout_rate: float = 0.25):
        super().__init__()
        self.skip, self.use_bilinear = skip, use_bilinear
        self.gates = (gate1, gate2)
        d1, d2 = dim1 // scale_dim1, dim2 // scale_dim2
        for tag, dim, dd, gate in (("1", dim1, d1, gate1),
                                   ("2", dim2, d2, gate2)):
            self.add_module(f"linear_h{tag}", nn.Linear(dim, dd))
            if gate and use_bilinear:
                self.register_parameter(f"bilinear_w{tag}", nn.Parameter(
                    torch.empty(dd, dim1, dim2)))
                self.register_parameter(f"bilinear_b{tag}", nn.Parameter(
                    torch.zeros(dd)))
            elif gate:
                self.add_module(f"linear_z{tag}", nn.Linear(dim1 + dim2, dd))
            self.add_module(f"linear_o{tag}", nn.Linear(dd, dd))
        self.encoder1 = nn.Linear((d1 + 1) * (d2 + 1), mmhid)
        self.encoder2 = nn.Linear(mmhid + (d1 + 1) + (d2 + 1) if skip
                                  else mmhid, mmhid)
        self.encoder1_bn = FlaxBatchNorm1d(mmhid)
        self.encoder2_bn = FlaxBatchNorm1d(mmhid)
        self.drop = nn.Dropout(dropout_rate)

    def _branch(self, tag: str, gate: int, vec_self, vec1, vec2):
        h = F.relu(getattr(self, f"linear_h{tag}")(vec_self))
        if gate:
            if self.use_bilinear:
                # z_k = vec1 W_k vec2 + b_k as one matmul against the
                # [dd * dim1, dim2] view of W (torch.bilinear launches a
                # small bmm per output feature on the card)
                w = getattr(self, f"bilinear_w{tag}")
                z = (F.linear(vec2, w.flatten(0, 1)).unflatten(1, w.shape[:2])
                     * vec1[:, None, :]).sum(dim=-1)
                z = z + getattr(self, f"bilinear_b{tag}")
            else:
                z = getattr(self, f"linear_z{tag}")(torch.cat([vec1, vec2],
                                                              dim=1))
            h = torch.sigmoid(z) * h
        return self.drop(F.relu(getattr(self, f"linear_o{tag}")(h)))

    def _encoder(self, name: str, x):
        x = getattr(self, name + "_bn")(getattr(self, name)(x))
        return self.drop(F.relu(x))

    def forward(self, vec1, vec2):
        vec1, vec2 = F.relu(vec1), F.relu(vec2)
        o1 = self._branch("1", self.gates[0], vec1, vec1, vec2)
        o2 = self._branch("2", self.gates[1], vec2, vec1, vec2)
        ones = o1.new_ones(o1.shape[0], 1)
        o1 = torch.cat([o1, ones], dim=1)
        o2 = torch.cat([o2, ones], dim=1)
        out = self.drop((o1[:, :, None] * o2[:, None, :]).flatten(1))
        out = self._encoder("encoder1", out)
        if self.skip:
            out = torch.cat([out, o1, o2], dim=1)
        return self._encoder("encoder2", out)


# the two vectors whose bilinear form gates each branch of a variant
# (JAX fusion.py:118-121; the reference's fusion.py:99-120 and 168-189)
TRILINEAR_GATE_PAIRS = {"A": {1: (0, 2), 2: (1, 2), 3: (0, 2)},
                        "B": {1: (0, 2), 2: (1, 0), 3: (0, 2)}}


class TrilinearFusion(nn.Module):
    """Three gated branches (``linear_h``; where the gate is on, a sigmoid
    of the bilinear form ``bilinear_w [dd, dim_a, dim_b]`` of the
    variant's pair of raw input vectors, or of ``linear_z`` on their
    concatenation without ``use_bilinear``; ``linear_o``), the outer
    product of the three outputs each with a 1 appended, ``encoder1``
    (Linear, ReLU, dropout), with ``skip`` the three outputs concatenated
    back, and ``encoder2``.  No BatchNorm.  The branch widths are ``dim /
    scale_dim``; dropout ``dropout_rate`` on the branch outputs, the
    product and the encoders' outputs."""

    def __init__(self, variant: str = "A", skip: int = 1,
                 use_bilinear: int = 1, gate1: int = 1, gate2: int = 1,
                 gate3: int = 1, dim1: int = 32, dim2: int = 32,
                 dim3: int = 32, scale_dim1: int = 1, scale_dim2: int = 1,
                 scale_dim3: int = 1, mmhid: int = 96,
                 dropout_rate: float = 0.25):
        super().__init__()
        self.variant, self.skip = variant, skip
        self.use_bilinear = use_bilinear
        self.gates = (gate1, gate2, gate3)
        self.pairs = TRILINEAR_GATE_PAIRS[variant]
        dims_og = (dim1, dim2, dim3)
        dims = (dim1 // scale_dim1, dim2 // scale_dim2, dim3 // scale_dim3)
        for tag in (1, 2, 3):
            dd, a, b = dims[tag - 1], *self.pairs[tag]
            self.add_module(f"linear_h{tag}", nn.Linear(dims_og[tag - 1], dd))
            if self.gates[tag - 1] and use_bilinear:
                self.register_parameter(f"bilinear_w{tag}", nn.Parameter(
                    torch.empty(dd, dims_og[a], dims_og[b])))
                self.register_parameter(f"bilinear_b{tag}", nn.Parameter(
                    torch.zeros(dd)))
            elif self.gates[tag - 1]:
                self.add_module(f"linear_z{tag}",
                                nn.Linear(dims_og[a] + dims_og[b], dd))
            self.add_module(f"linear_o{tag}", nn.Linear(dd, dd))
        d1, d2, d3 = (d + 1 for d in dims)
        self.encoder1 = nn.Linear(d1 * d2 * d3, mmhid)
        self.encoder2 = nn.Linear(mmhid + d1 + d2 + d3 if skip else mmhid,
                                  mmhid)
        self.drop = nn.Dropout(dropout_rate)

    def forward(self, vec1, vec2, vec3):
        vecs = (vec1, vec2, vec3)
        outs = []
        for tag in (1, 2, 3):
            h = F.relu(getattr(self, f"linear_h{tag}")(vecs[tag - 1]))
            if self.gates[tag - 1]:
                va, vb = (vecs[i] for i in self.pairs[tag])
                if self.use_bilinear:
                    z = (torch.einsum("bi,kij,bj->bk", va,
                                      getattr(self, f"bilinear_w{tag}"), vb)
                         + getattr(self, f"bilinear_b{tag}"))
                else:
                    z = getattr(self, f"linear_z{tag}")(torch.cat([va, vb],
                                                                  dim=1))
                h = torch.sigmoid(z) * h
            o = self.drop(F.relu(getattr(self, f"linear_o{tag}")(h)))
            outs.append(torch.cat([o, o.new_ones(o.shape[0], 1)], dim=1))
        o1, o2, o3 = outs
        o123 = ((o1[:, :, None] * o2[:, None, :]).flatten(1)[:, :, None]
                * o3[:, None, :]).flatten(1)
        out = self.drop(F.relu(self.encoder1(self.drop(o123))))
        if self.skip:
            out = torch.cat([out, o1, o2, o3], dim=1)
        return self.drop(F.relu(self.encoder2(out)))
