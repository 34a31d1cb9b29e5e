"""Plain PyTorch reference of the two-scale teacher (``TeachersNet``) and
student (``StudentsNet``) of the diag2021 preset, their losses, the
classifier gradient modulation and one AdamW train step.

A frozen copy of the port's model code as it stood when the benchmark was
written, with every hand kernel replaced by the plain arithmetic it
computes: the table CPB blends its windows by one gather (K1, K5), the
exact CPB evaluates the MLP at every (kv, query) pair (K2), and DPC-KNN
takes the full ``[B, N, N]`` distances (K3).  It imports nothing of the
port and nothing of JAX, so the program cannot move it.

The parameter names are the port's, so one state dict loads into both
with ``strict=True``.  The random draws (dropout, AlphaDropout, the
student's density noise) come from torch's global generator in the same
order as the port's forward takes them, so that a run seeded alike on the
same device draws the same masks.  On the card with ``attn_bf16_streams``
the attention's operands and its ``[B, H, K, N]`` streams are bf16 and the
softmax reduces in f32; everything else is f32, as the configuration
states.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6
CLASS_COL = {"diag2021": 5, "grade": 4, "subtype": 7}


def layer_norm(dim):
    return nn.LayerNorm(dim, eps=LN_EPS)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

class Pooler(nn.Module):
    def __init__(self, hidden_size):
        super().__init__()
        self.dense = nn.Linear(hidden_size, hidden_size)

    def forward(self, h):
        return torch.tanh(self.dense(h.mean(dim=1)))


class FusionNet(nn.Module):
    def __init__(self, dim=128):
        super().__init__()
        self.fusion_layer = nn.Linear(2 * dim, dim)

    def forward(self, a, b):
        return self.fusion_layer(torch.cat([a, b], dim=-1))


class TransFusionLayer(nn.Module):
    def __init__(self, dim=128):
        super().__init__()
        self.norm = layer_norm(dim)
        self.multihead_attn = nn.MultiheadAttention(dim, 8, dropout=0.1,
                                                    batch_first=True)
        self.pooler = Pooler(dim)

    def forward(self, x1, x2):
        kv = self.norm(x2)
        out, _ = self.multihead_attn(self.norm(x1), kv, kv,
                                     need_weights=False)
        return self.pooler(self.norm(x1 + out))[:, None, :]


class MaxNet(nn.Module):
    def __init__(self, input_dim, omic_dim, dropout_rate, label_dim):
        super().__init__()
        dims = [input_dim, 64, 48, 32, omic_dim]
        self.encoder = nn.Sequential(*[
            nn.Sequential(nn.Linear(dims[i], dims[i + 1]), nn.ELU(),
                          nn.AlphaDropout(dropout_rate))
            for i in range(4)])
        self.classifier = nn.Sequential(nn.Linear(omic_dim, label_dim))

    def forward(self, x):
        f = self.encoder(x).relu()
        return f, self.classifier(f)


def combine_logits(l1, l2, kind):
    if kind == "max_confidence":
        c1 = torch.softmax(l1, dim=1).amax(dim=1, keepdim=True)
        c2 = torch.softmax(l2, dim=1).amax(dim=1, keepdim=True)
        return torch.where(c1 > c2, l1, l2)
    raise ValueError(f"combination {kind!r} is not in the reference")


# ---------------------------------------------------------------------------
# continuous position bias
# ---------------------------------------------------------------------------

def table_consts(side, kv_bound, divisor=1):
    h = (2.0 / (side - 1)) / divisor
    n_lo = int(-(-(1.0 + kv_bound) // h)) + 2
    rn = -(-(2 * n_lo + 1) // divisor)
    return h, -n_lo * h, rn * divisor


def kv_bound_2d(offset_scale, gh, gw):
    g = min(gh, gw)
    return 1.0 + 2.0 * offset_scale / (g - 1) if g > 1 else 0.0


def mlp_coords(x):
    return torch.sign(x) * torch.log1p(torch.abs(x))


def cpb_table(w1, b1, w2, b2, w3, b3, side, kv_bound, divisor):
    """The MLP on the ``[tn, tn]`` lattice of spacing (query spacing) /
    ``divisor``."""
    h, t0, tn = table_consts(side, kv_bound, divisor)
    f = mlp_coords(t0 + h * torch.arange(tn, dtype=torch.float32,
                                         device=w1.device))
    hid = torch.relu(f[None, :, None] * w1[0] + f[:, None, None] * w1[1] + b1)
    hid = torch.relu(hid @ w2 + b2)
    return (hid @ w3 + b3)[..., 0]


def table_windows(table, grid_kv, side, kv_bound, divisor):
    """Each kv row's ``[side, side]`` window of the table, blended
    bilinearly from its four taps, y first, then x; a tap is clipped into
    the table and a clipped row extrapolates."""
    h, t0, tn = table_consts(side, kv_bound, divisor)
    ty = (-1.0 - grid_kv[..., 1] - t0) / h
    tx = (-1.0 - grid_kv[..., 0] - t0) / h
    shifts = torch.stack([ty, tx], dim=-1).reshape(-1, 2)
    hi = (tn // divisor - side) * divisor + divisor - 2
    i0 = torch.clamp(torch.floor(shifts), 0.0, float(hi))
    taps, fr = i0.long(), shifts - i0
    if divisor == 1:
        off = torch.arange(side + 1, device=table.device)
        first, second = slice(0, -1), slice(1, None)
    else:
        i = torch.arange(2 * side, device=table.device)
        off = divisor * (i // 2) + i % 2
        first, second = slice(0, None, 2), slice(1, None, 2)
    win = table[(taps[:, 0:1] + off)[:, :, None],
                (taps[:, 1:2] + off)[:, None, :]]
    fy, fx = fr[:, 0, None, None], fr[:, 1, None, None]
    ty = win[:, first] * (1 - fy) + win[:, second] * fy
    return ty[:, :, first] * (1 - fx) + ty[:, :, second] * fx


def cpb_exact(grid_q, grid_kv, w1, b1, w2, b2, w3, b3):
    """The MLP at every (kv, query) pair -> ``[BG, K, N]``."""
    pos = grid_q[None, None, :, :] - grid_kv[:, :, None, :]
    h = torch.relu(mlp_coords(pos) @ w1 + b1)
    h = torch.relu(h @ w2 + b2)
    return (h @ w3 + b3)[..., 0]


class CPB(nn.Module):
    def __init__(self, dim, heads, offset_groups):
        super().__init__()
        self.heads, self.offset_groups = heads, offset_groups
        self.mlp = nn.Sequential(
            nn.Sequential(nn.Linear(2, dim), nn.ReLU()),
            nn.Sequential(nn.Linear(dim, dim), nn.ReLU()),
            nn.Linear(dim, heads // offset_groups))

    def forward(self, grid_q, grid_kv, side, divisor, kv_bound, out_dtype):
        l1, l2, l3 = self.mlp[0][0], self.mlp[1][0], self.mlp[2]
        w = (l1.weight.t().contiguous(), l1.bias, l2.weight.t().contiguous(),
             l2.bias, l3.weight.t().contiguous(), l3.bias)
        bg, k, _ = grid_kv.shape
        if self.heads // self.offset_groups != 1:
            raise ValueError("the reference's CPB has one channel a group")
        if divisor > 0:
            table = cpb_table(*w, side, kv_bound, divisor)
            bias = table_windows(table, grid_kv, side, kv_bound,
                                 divisor).to(out_dtype)
        else:
            bias = cpb_exact(grid_q, grid_kv, *w)
        return bias.reshape(bg // self.offset_groups, self.heads, k,
                            grid_q.shape[0])


# ---------------------------------------------------------------------------
# deformable 2-D cross attention ("kn" layout)
# ---------------------------------------------------------------------------

class PointwiseConv(nn.Module):
    def __init__(self, cin, cout, groups=1, bias=False):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, 1, 1))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x, dtype=None):
        w = self.weight.flatten(1)
        if dtype is not None:
            x, w = x.to(dtype), w.to(dtype)
        g = self.groups
        if g == 1:
            y = F.linear(x, w)
        else:
            y = torch.einsum("...gi,goi->...go", x.unflatten(-1, (g, -1)),
                             w.unflatten(0, (g, -1))).flatten(-2)
        y = y.float()
        return y if self.bias is None else y + self.bias


class Scale(nn.Module):
    def __init__(self, scale):
        super().__init__()
        self.scale = scale

    def forward(self, x):
        return x * self.scale


def normalized_grid(h, w, device):
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device),
                            indexing="ij")
    return torch.stack([xs * (2.0 / max(w - 1, 1)) - 1.0,
                        ys * (2.0 / max(h - 1, 1)) - 1.0], dim=-1)


class DeformCrossAttention2D(nn.Module):
    """x1 queries, x2 sampled as kv on a deformed grid; returns ``(out [B,
    N, C], attn [B, H, K, N])``, the map before dropout."""

    def __init__(self, dim, cpb_table_divisor, attn_bf16_streams,
                 dim_head=64, heads=8, dropout=0.1, downsample_factor=4,
                 offset_scale=4.0, offset_groups=8, offset_kernel_size=6):
        super().__init__()
        inner = dim_head * heads
        od = inner // offset_groups
        self.dim_head, self.heads, self.offset_groups = (dim_head, heads,
                                                         offset_groups)
        self.dropout = dropout
        self.offset_scale = offset_scale
        self.cpb_table_divisor = cpb_table_divisor
        self.attn_bf16_streams = attn_bf16_streams
        self.to_q = PointwiseConv(dim, inner, groups=offset_groups)
        self.to_k = PointwiseConv(dim, inner, groups=offset_groups)
        self.to_v = PointwiseConv(dim, inner, groups=offset_groups)
        pad = (offset_kernel_size - downsample_factor) // 2
        self.to_offsets = nn.Sequential(
            nn.Conv2d(od, od, offset_kernel_size, stride=downsample_factor,
                      padding=pad, groups=od),
            nn.GELU(), nn.Conv2d(od, 2, 1, bias=False), nn.Tanh(),
            Scale(offset_scale))
        self.rel_pos_bias = CPB(dim // 4, heads, offset_groups)
        self.to_out = PointwiseConv(inner, dim, bias=True)

    def forward(self, x1, x2):
        B, N, _ = x1.shape
        side = math.isqrt(N)
        G, H, dh = self.offset_groups, self.heads, self.dim_head
        low = self.attn_bf16_streams and x1.is_cuda
        cdt = torch.bfloat16 if low else None
        sdt = torch.bfloat16 if low else torch.float32
        q = self.to_q(x1, cdt)
        qg = q.reshape(B, side, side, G, -1).permute(0, 3, 4, 1, 2)
        off = self.to_offsets(qg.reshape(B * G, -1, side, side))
        gh, gw = off.shape[-2:]
        base = torch.stack(torch.meshgrid(
            torch.arange(gw, dtype=off.dtype, device=off.device),
            torch.arange(gh, dtype=off.dtype, device=off.device),
            indexing="xy"))
        vgrid = base + off
        pts = torch.stack([vgrid[:, 0] * (2.0 / max(gw - 1, 1)) - 1.0,
                           vgrid[:, 1] * (2.0 / max(gh - 1, 1)) - 1.0],
                          dim=-1)
        x2g = x2.reshape(B, side, side, G, -1).permute(0, 3, 4, 1, 2)
        kv = F.grid_sample(x2g.reshape(B * G, -1, side, side), pts,
                           mode="bilinear", padding_mode="zeros",
                           align_corners=False)
        K = gh * gw
        kv = kv.reshape(B, G, -1, K).permute(0, 3, 1, 2).reshape(B, K, -1)
        k = self.to_k(kv, cdt)
        v = self.to_v(kv, cdt)

        def split(t):
            return t.reshape(B, -1, H, dh).transpose(1, 2)

        qh = split(q) * dh ** -0.5
        kh, vh = split(k), split(v)
        divisor = self.cpb_table_divisor if min(gh, gw) > 1 else 0
        bias = self.rel_pos_bias(
            normalized_grid(side, side, x1.device).reshape(N, 2),
            pts.reshape(B * G, K, 2), side, divisor,
            kv_bound_2d(self.offset_scale, gh, gw), torch.float32)
        opd = cdt or torch.float32
        sim = torch.matmul(kh.to(opd), qh.to(opd).transpose(-1, -2)).to(sdt)
        sim = sim + bias.to(sdt)
        attn = torch.softmax(sim.float(), dim=-2).to(sdt)
        dropped = F.dropout(attn, self.dropout, self.training)
        out = torch.matmul(dropped.transpose(-1, -2).to(opd),
                           vh.to(opd)).float()
        out = out.transpose(1, 2).reshape(B, N, H * dh)
        return self.to_out(out), attn


# ---------------------------------------------------------------------------
# DPC-KNN cluster merge
# ---------------------------------------------------------------------------

def pairwise_dist(x, y, eps=1e-12):
    x2 = (x * x).sum(dim=-1, keepdim=True)
    y2 = (y * y).sum(dim=-1, keepdim=True)
    d2 = x2 + y2.transpose(1, 2) - 2.0 * torch.bmm(x, y.transpose(1, 2))
    return torch.sqrt(d2.clamp_min(eps))


def pinned_density_noise(shape, device):
    """The fixed tie-break draw of eval: ``torch.rand`` from a CPU
    generator seeded with 0."""
    g = torch.Generator().manual_seed(0)
    return torch.rand(tuple(shape), generator=g).to(device)


@torch.no_grad()
def dpc_knn_cluster(x, cluster_num, k, density_noise):
    """Density peaks over the k nearest neighbours, the centres by top-k of
    ``parent distance * density`` (a stable sort: equal scores by
    ascending index), every token to its nearest centre."""
    B, N, C = x.shape
    x = x.detach().float()
    x2 = (x * x).sum(dim=-1)
    d2 = (x2[:, None, :] + x2[:, :, None]) - 2.0 * torch.bmm(
        x, x.transpose(1, 2))
    knn2 = torch.topk(d2, k, dim=-1, largest=False).values
    density = torch.exp(-knn2.clamp_min(1e-12).mean(dim=-1) / C)
    density = density + density_noise * 1e-6
    higher = density[:, None, :] > density[:, :, None]
    parent2 = torch.where(higher, d2, torch.full_like(d2, 3.0e38)).amin(-1)
    scale = 1.0 / (C ** 0.5)
    dist_max = torch.sqrt(d2.amax(dim=-1).amax(dim=1).clamp_min(1e-12)) * scale
    parent_dist = torch.minimum(torch.sqrt(parent2.clamp_min(1e-12)) * scale,
                                dist_max[:, None])
    index_down = torch.sort(parent_dist * density, dim=-1, descending=True,
                            stable=True).indices[:, :cluster_num]
    xc = torch.gather(x, 1, index_down[:, :, None].expand(-1, -1, C))
    idx = (pairwise_dist(xc, x) * scale).argmin(dim=1)
    ids = torch.arange(cluster_num, device=x.device).expand(B, -1)
    return idx.scatter(1, index_down, ids)


def merge_tokens(x, idx_cluster, cluster_num, token_weight):
    w = token_weight[..., 0]
    onehot = F.one_hot(idx_cluster, cluster_num).to(x.dtype)
    all_weight = torch.einsum("bnk,bn->bk", onehot, w) + 1e-6
    denom = torch.einsum("bnk,bk->bn", onehot, all_weight)
    return torch.einsum("bnk,bnc->bkc", onehot * (w / denom)[..., None], x)


class ClusterMergeNet(nn.Module):
    def __init__(self, dim, sample_ratio, min_clusters=2):
        super().__init__()
        self.sample_ratio, self.min_clusters = sample_ratio, min_clusters
        self.norm = layer_norm(dim)
        self.score = nn.Linear(dim, 1)

    def forward(self, x):
        B, N, _ = x.shape
        x = self.norm(x)
        token_weight = torch.exp(self.score(x))
        n = max(max(math.ceil(N * self.sample_ratio), 1), self.min_clusters)
        noise = (torch.rand((B, N), device=x.device) if self.training
                 else pinned_density_noise((B, N), x.device))
        idx = dpc_knn_cluster(x, n, 5, noise)
        return merge_tokens(x, idx, n, token_weight)


# ---------------------------------------------------------------------------
# teacher and student
# ---------------------------------------------------------------------------

class TeacherEncoder(nn.Module):
    def __init__(self, dim, **attn):
        super().__init__()
        self.norm = layer_norm(dim)
        self.attn2d_omic1 = DeformCrossAttention2D(dim, **attn)
        self.attn2d_omic2 = DeformCrossAttention2D(dim, **attn)
        self.fusion_layer = FusionNet(dim)
        self.transfusion_layer1 = TransFusionLayer(dim)
        self.transfusion_layer2 = TransFusionLayer(dim)

    def forward(self, x1, x2):
        norm = self.norm
        x2n = norm(x2)
        a1, attn1 = self.attn2d_omic1(norm(x1[0]), x2n)
        a2, attn2 = self.attn2d_omic2(norm(x1[1]), x2n)
        x = self.fusion_layer(x1[0] + a1, x1[1] + a2)
        query = norm(x)
        f1 = self.transfusion_layer1(query, norm(x1[0][:, :1, :]))
        f2 = self.transfusion_layer2(query, norm(x1[1][:, :1, :]))
        return f1, f2, attn1, attn2


class TeacherNet(nn.Module):
    def __init__(self, label_dim, input_dim, path_dim, **attn):
        super().__init__()
        self._fc1 = nn.Sequential(nn.Linear(input_dim, path_dim), nn.ReLU())
        self.encoder = TeacherEncoder(path_dim, **attn)
        self.norm = layer_norm(path_dim)
        self.pooler1 = Pooler(path_dim)
        self.pooler2 = Pooler(path_dim)
        self.classifier = nn.Linear(2 * path_dim, label_dim)

    def forward(self, path, omics):
        path = self._fc1(path)
        queries = tuple(o[:, None, :].expand(path.shape) for o in omics)
        f1, f2, att1, att2 = self.encoder(queries, path)
        feature1 = self.pooler1(self.norm(f1))
        feature2 = self.pooler2(self.norm(f2))
        logits = self.classifier(torch.cat([feature1, feature2], dim=-1))
        return logits, feature1, feature2, att1, att2


class TeachersNet(nn.Module):
    def __init__(self, s):
        super().__init__()
        self.combination_type = s["combination_type_teas"]
        self.omic_net_tumor = MaxNet(s["input_size_omic_tumor"],
                                     s["omic_dim"], s["dropout_rate"],
                                     s["label_dim"])
        self.omic_net_immune = MaxNet(s["input_size_omic_immune"],
                                      s["omic_dim"], s["dropout_rate"],
                                      s["label_dim"])
        kw = dict(label_dim=s["label_dim"], input_dim=s["input_path_dim"],
                  path_dim=s["path_dim"], **_attn_settings(s))
        self.teacher10_net = TeacherNet(**kw)
        self.teacher20_net = TeacherNet(**kw)

    def forward(self, x_path10, x_path20, x_omic_tumor, x_omic_immune):
        omics = [self.omic_net_tumor(x_omic_tumor)[0],
                 self.omic_net_immune(x_omic_immune)[0]]
        l10, f1_10, f2_10, a1_10, a2_10 = self.teacher10_net(x_path10, omics)
        l20, f1_20, f2_20, a1_20, a2_20 = self.teacher20_net(x_path20, omics)
        logits = {"logits_tea10": l10, "logits_tea20": l20,
                  "logits_teas": combine_logits(l10, l20,
                                                self.combination_type)}
        maps = {"att1_tea10": a1_10, "att1_tea20": a1_20,
                "att2_tea10": a2_10, "att2_tea20": a2_20}
        modulated = [(self.teacher10_net.classifier, f1_10, f2_10),
                     (self.teacher20_net.classifier, f1_20, f2_20)]
        return logits, maps, modulated


class StudentNet(nn.Module):
    def __init__(self, label_dim, input_dim, path_dim, sample_ratio, **attn):
        super().__init__()
        self._fc1 = nn.Sequential(nn.Linear(input_dim, path_dim), nn.ReLU())
        self.encoder = nn.Module()
        self.encoder.norm = layer_norm(path_dim)
        self.encoder.attn2d = DeformCrossAttention2D(path_dim, **attn)
        self.encoder.cluster_merge = ClusterMergeNet(path_dim, sample_ratio)
        self.classifier = nn.Linear(2 * path_dim, label_dim)

    def forward(self, path):
        path = self._fc1(path)
        enc = self.encoder
        a, att = enc.attn2d(enc.norm(path), enc.norm(path))
        feature = enc.cluster_merge(path + a)
        logits = self.classifier(torch.cat([feature[:, 0], feature[:, 1]],
                                           dim=-1))
        return logits, att


class StudentsNet(nn.Module):
    def __init__(self, s):
        super().__init__()
        self.combination_type = s["combination_type_stus"]
        kw = dict(label_dim=s["label_dim"], input_dim=s["input_path_dim"],
                  path_dim=s["path_dim"], sample_ratio=s["path_cluster_num"],
                  **_attn_settings(s))
        self.student10_net = StudentNet(**kw)
        self.student20_net = StudentNet(**kw)

    def forward(self, x_path10, x_path20):
        l10, a10 = self.student10_net(x_path10)
        l20, a20 = self.student20_net(x_path20)
        logits = {"logits_stu10": l10, "logits_stu20": l20,
                  "logits_stus": combine_logits(l10, l20,
                                                self.combination_type)}
        return logits, {"att_stu10": a10, "att_stu20": a20}, []


def _attn_settings(s):
    for key, want in (("fused_table_attention", False),
                      ("cpb_table_bf16", False)):
        if s.get(key, False) != want:
            raise ValueError(f"{key}={s[key]!r} is not in the reference")
    return dict(cpb_table_divisor=int(s["cpb_table_divisor"]),
                attn_bf16_streams=bool(s["attn_bf16_streams"]))


MODELS = {"teacher": TeachersNet, "student": StudentsNet}
INPUTS = {"teacher": ("x_path10", "x_path20", "x_omic_tumor",
                      "x_omic_immune"),
          "student": ("x_path10", "x_path20")}
TAGS = {"teacher": ("tea10", "tea20", "teas"),
        "student": ("stu10", "stu20", "stus")}


def build(settings, device):
    """The reference model of ``settings['mode']`` on ``device`` (weights
    uninitialised: load a state dict)."""
    return MODELS[settings["mode"]](settings).to(device)


# ---------------------------------------------------------------------------
# losses, modulation, the train step
# ---------------------------------------------------------------------------

def weighted_cross_entropy(logits, labels, class_weights):
    nll = -torch.log_softmax(logits, dim=-1).gather(1, labels[:, None])[:, 0]
    w = class_weights[labels]
    return (w * nll).sum() / w.sum()


def gram_mean(a):
    a = a.float().flatten(2).transpose(0, 1)
    s = a @ a.transpose(1, 2)
    return (s / torch.linalg.vector_norm(s, dim=2, keepdim=True)).mean(0)


def path_batch_loss(att10, att20):
    m10, m20 = gram_mean(att10), gram_mean(att20)
    return ((m10 - m20) ** 2 / m10.shape[0]).sum()


def omic_domain_scale_loss(a1_10, a1_20, a2_10, a2_20):
    def sim_loss(a, b):
        s = a.float().flatten(1) @ b.float().flatten(1).t()
        s = s / torch.linalg.vector_norm(s, dim=1, keepdim=True)
        return 10000.0 * torch.diagonal(s).var(unbiased=True)

    return sim_loss(a1_10, a1_20) + sim_loss(a2_10, a2_20)


def loss_of(mode, logits, maps, label, class_weights, task,
            multiscale_attention=True):
    """``(loss, parts)``: the two-scale task loss plus the attention
    consistency loss, and each of the two."""
    y = label[:, CLASS_COL[task]].long()
    tags = TAGS[mode][:2]
    taskloss = sum(weighted_cross_entropy(logits[f"logits_{t}"], y,
                                          class_weights) for t in tags)
    parts = {"taskloss": taskloss}
    loss = taskloss
    if multiscale_attention:
        if mode == "student":
            batchloss = 1000.0 * path_batch_loss(maps["att_stu10"],
                                                 maps["att_stu20"])
        else:
            batchloss = omic_domain_scale_loss(
                maps["att1_tea10"], maps["att1_tea20"], maps["att2_tea10"],
                maps["att2_tea20"])
        loss = loss + batchloss
        parts["batchloss"] = batchloss
    return loss, parts


def _project_rows(g_weak, g_strong):
    dot = (g_weak * g_strong).sum(dim=1, keepdim=True)
    proj = dot / (g_strong * g_strong).sum(dim=1, keepdim=True).clamp_min(
        1e-12) * g_strong
    g1 = g_weak - proj
    perpen = g1 - proj
    unit = perpen / torch.linalg.vector_norm(
        perpen, dim=1, keepdim=True).clamp_min(1e-12)
    return torch.linalg.vector_norm(g1, dim=1, keepdim=True) * unit


@torch.no_grad()
def modulate(weight_grad, feature1, feature2, weight, bias, labels):
    """The two-branch classifier's modulated weight gradient: a conflicting
    row of the weaker branch replaced by its projection."""
    hs = feature1.shape[-1]
    y = labels[:, None].long()
    s1 = torch.softmax(feature1 @ weight[:, :hs].t() + bias / 2,
                       dim=-1).gather(1, y).sum()
    s2 = torch.softmax(feature2 @ weight[:, hs:].t() + bias / 2,
                       dim=-1).gather(1, y).sum()
    ratio1 = s1 / s2
    ratio2 = 1.0 / ratio1
    g1, g2 = weight_grad[:, :hs], weight_grad[:, hs:]
    sim = (g1 * g2).sum(dim=1, keepdim=True) / (
        torch.linalg.vector_norm(g1, dim=1, keepdim=True)
        * torch.linalg.vector_norm(g2, dim=1, keepdim=True)).clamp_min(1e-12)
    conflict = sim < 0
    new1 = torch.where(conflict & (ratio1 < 1), _project_rows(g1, g2), g1)
    new2 = torch.where(conflict & (ratio1 >= 1) & (ratio2 < 1),
                       _project_rows(g2, g1), g2)
    return torch.cat([new1, new2], dim=1)


def cosine_lr(settings, steps_per_epoch):
    """``step -> lr`` of the ``cosine`` policy: from ``lr`` down to 0 over
    ``epochs * steps_per_epoch`` steps."""
    if settings["lr_policy"] != "cosine":
        raise ValueError(f"lr_policy {settings['lr_policy']!r} is not in "
                         "the reference")
    lr, total = float(settings["lr"]), max(1, int(settings["epochs"])
                                           * steps_per_epoch)
    return lambda step: lr * 0.5 * (1 + math.cos(math.pi * min(step, total)
                                                 / total))


class Trainer:
    """The reference's train step: train-mode forward, the loss,
    backward, a zero gradient for every parameter the loss does not
    reach, the teachers' classifier modulation, AdamW at the scheduled lr
    (torch's default AdamW: bias corrections in float64)."""

    def __init__(self, model, settings, steps_per_epoch, class_weights):
        if settings["optimizer"] != "adamw":
            raise ValueError("the reference trains with AdamW")
        self.model, self.s = model, settings
        self.mode = settings["mode"]
        self.params = list(model.parameters())
        self.opt = torch.optim.AdamW(self.params, lr=1.0,
                                     weight_decay=float(
                                         settings["weight_decay"]))
        self.lr = cosine_lr(settings, steps_per_epoch)
        self.count = 0
        self.cw = class_weights

    def step(self, tensors):
        model, s = self.model, self.s
        model.train()
        self.opt.zero_grad(set_to_none=True)
        label = tensors["label"]
        logits, maps, modulated = model(*(tensors[k]
                                          for k in INPUTS[self.mode]))
        loss, parts = loss_of(self.mode, logits, maps, label, self.cw,
                              s["task_type"], s["multiscale_attention"])
        self.parts = {k: v.detach() for k, v in parts.items()}
        loss.backward()
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if s["gradient_modulate"]:
            y = label[:, CLASS_COL[s["task_type"]]]
            for cls, f1, f2 in modulated:
                cls.weight.grad = modulate(cls.weight.grad, f1.detach(),
                                           f2.detach(), cls.weight.detach(),
                                           cls.bias.detach(), y)
        for group in self.opt.param_groups:
            group["lr"] = self.lr(self.count)
        self.opt.step()
        self.count += 1
        return loss.detach()
