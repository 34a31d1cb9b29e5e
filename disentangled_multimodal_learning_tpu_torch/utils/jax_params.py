"""JAX params (as numpy) into the port, loaded with ``strict=True`` (a
reference-named ``.pth`` state_dict loads through ``utils/checkpoint.py``).

JAX params go through the port's own name map below (a copy of the JAX
package's numpy-only exporter ``utils/torch_export.py``, so that the port
imports nothing of that package): it writes the reference's names and torch
layouts, which the port's modules carry.  The map covers the modes the port
has; a param tree in JAX's ``stacked_scales`` layout (``teacher_nets``,
``student_nets``, ``scale_nets``: both scales' subnetworks on a leading
axis of 2, JAX ``parallel/branch_shard.py``) is unstacked first
(:func:`unstack_scale_params`; :func:`stack_scale_params` is its
inverse).  The reference's members that its forward never uses (StudentNet's ``norm`` and ``pooler1``, the attention of the
other ``attn_dim`` in ``DeformCrossTransLayer``) have no counterpart in
the port, so the load stays strict.

The baselines have no reference-name map in JAX (``utils/torch_export.py``
stops at the deformable modes), so their port modules carry the flax
module names (``attention_0``, ``path_net.classifier``,
``fusion.encoder1_bn``, ...): kernels are transposed, conv filters
reshaped to torch's ``[C, 1, k, k]`` (PPEG) and ``[h, 1, 33, 1]`` (the
Nystrom ``res_conv``), q/k/v packed into ``in_proj``, and BatchNorm's
running statistics come from JAX's ``batch_stats`` collection.
:func:`jax_module_state_dict` does the same for the modules no mode builds
(``GatedABMIL``, ``TrilinearFusion``, ``FeedForward``, ``CrossAttLayer``,
``Nystromformer``).
"""

from __future__ import annotations

import numpy as np
import torch


# JAX's stacked module -> the unstacked per-scale modules it replaces
STACKED_NAMES = {
    "teacher_nets": ("teacher10_net", "teacher20_net"),
    "student_nets": ("student10_net", "student20_net"),
    "scale_nets": ("scale10_net", "scale20_net"),
}


def _np(v):
    return np.asarray(v, dtype=np.float32)


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def stack_scale_params(params: dict) -> dict:
    """An unstacked param tree (``teacher10_net`` / ``teacher20_net`` ...)
    in JAX's ``stacked_scales`` layout (one ``teacher_nets`` subtree whose
    leaves have a leading axis of 2); other subtrees pass through (JAX
    ``branch_shard.stack_scale_params``)."""
    out, used = {}, set()
    for stacked, (n10, n20) in STACKED_NAMES.items():
        if n10 in params and n20 in params:
            out[stacked] = _tree_map(lambda a, b: np.stack(
                [np.asarray(a), np.asarray(b)]), params[n10], params[n20])
            used.update((n10, n20))
    out.update({k: v for k, v in params.items() if k not in used})
    return out


def unstack_scale_params(params: dict) -> dict:
    """The inverse of :func:`stack_scale_params` (JAX
    ``branch_shard.unstack_scale_params``)."""
    out = {}
    for k, v in params.items():
        if k in STACKED_NAMES:
            for i, name in enumerate(STACKED_NAMES[k]):
                out[name] = _tree_map(lambda a: np.asarray(a)[i], v)
        else:
            out[k] = v
    return out


def _dense(p, key, out):
    out[f"{key}.weight"] = _np(p["kernel"]).T
    if "bias" in p:
        out[f"{key}.bias"] = _np(p["bias"])


def _ln(p, key, out):
    out[f"{key}.weight"] = _np(p["scale"])
    out[f"{key}.bias"] = _np(p["bias"])


def _mha(p, key, out):
    out[f"{key}.in_proj_weight"] = np.concatenate(
        [_np(p[n]["kernel"]).T for n in ("q_proj", "k_proj", "v_proj")], 0)
    out[f"{key}.in_proj_bias"] = np.concatenate(
        [_np(p[n]["bias"]) for n in ("q_proj", "k_proj", "v_proj")])
    _dense(p["out_proj"], f"{key}.out_proj", out)


def _grouped_pointwise(p, key, out):
    k = _np(p["kernel"])  # [G, ci, co] -> grouped 1x1 conv [G*co, ci, 1, 1]
    out[f"{key}.weight"] = np.concatenate([g.T for g in k], 0)[:, :, None, None]


def _cpb(p, key, out):
    for i, name in ((0, "mlp.0.0"), (1, "mlp.1.0"), ("out", "mlp.2")):
        out[f"{key}.{name}.weight"] = _np(p[f"mlp_{i}_kernel"]).T
        out[f"{key}.{name}.bias"] = _np(p[f"mlp_{i}_bias"])


def _attn2d(p, key, out):
    for name in ("to_q", "to_k", "to_v"):
        _grouped_pointwise(p[name], f"{key}.{name}", out)
    dw = _np(p["offset_conv"]["kernel"])  # HWIO [k, k, 1, C]
    out[f"{key}.to_offsets.0.weight"] = dw.transpose(3, 2, 0, 1)
    out[f"{key}.to_offsets.0.bias"] = _np(p["offset_conv"]["bias"])
    ow = _np(p["offset_out"]["kernel"])  # [od, 2]
    out[f"{key}.to_offsets.2.weight"] = ow.T[:, :, None, None]
    _cpb(p["rel_pos_bias"], f"{key}.rel_pos_bias", out)
    out[f"{key}.to_out.weight"] = _np(p["to_out"]["kernel"]).T[:, :, None, None]
    out[f"{key}.to_out.bias"] = _np(p["to_out"]["bias"])


def _attn1d(p, key, out):
    for name in ("to_q", "to_k", "to_v"):  # Dense [in, out] -> Conv1d
        out[f"{key}.{name}.weight"] = _np(p[name]["kernel"]).T[:, :, None]
    dw = _np(p["offset_conv_kernel"])  # HIO [k, 1, od]
    out[f"{key}.to_offsets.0.weight"] = dw.transpose(2, 1, 0)
    out[f"{key}.to_offsets.0.bias"] = _np(p["offset_conv_bias"])
    ow = _np(p["offset_out"]["kernel"])  # [od, 1]
    out[f"{key}.to_offsets.2.weight"] = ow.T[:, :, None]
    _cpb(p["rel_pos_bias"], f"{key}.rel_pos_bias", out)
    out[f"{key}.to_out.weight"] = _np(p["to_out"]["kernel"]).T[:, :, None]
    out[f"{key}.to_out.bias"] = _np(p["to_out"]["bias"])


def _maxnet(p, key, out):
    pre = f"{key}." if key else ""
    for i in range(4):
        _dense(p[f"encoder_{i}"], f"{pre}encoder.{i}.0", out)
    if "classifier" in p:
        _dense(p["classifier"], f"{pre}classifier.0", out)


def _nystrom_layer(p, key, out):
    _ln(p["norm"], f"{key}.norm", out)
    _nystrom_attention(p["attn"], f"{key}.attn", out)


def _nystrom_attention(a, key, out):
    _dense(a["to_qkv"], f"{key}.to_qkv", out)
    if "res_conv" in a:
        # [33, 1, 1, h] -> Conv2d(h, h, (33, 1), groups=h) weight [h, 1, 33, 1]
        out[f"{key}.res_conv.weight"] = _np(a["res_conv"]).transpose(3, 2,
                                                                      0, 1)
    _dense(a["to_out"], f"{key}.to_out", out)


def _ppeg(p, key, out):
    for name in ("proj", "proj1", "proj2"):  # HWIO [k, k, 1, C]
        out[f"{key}.{name}.weight"] = _np(p[name]).transpose(3, 2, 0, 1)
        out[f"{key}.{name}.bias"] = _np(p[f"{name}_bias"])


def _bilinear_fusion(p, bs, key, out):
    """BilinearFusion; ``bs`` its ``batch_stats`` (None: flax's initial
    statistics, mean 0 and variance 1)."""
    pre = f"{key}." if key else ""
    for name, sub in p.items():
        if name.startswith("bilinear_"):
            out[pre + name] = _np(sub)
        elif name.endswith("_bn"):
            _ln(sub, pre + name, out)
            stats = (bs or {}).get(name)
            n = _np(sub["scale"]).shape[0]
            out[f"{pre}{name}.running_mean"] = (
                _np(stats["mean"]) if stats else np.zeros(n, np.float32))
            out[f"{pre}{name}.running_var"] = (
                _np(stats["var"]) if stats else np.ones(n, np.float32))
        else:
            _dense(sub, pre + name, out)


def _abmil(p, key, out):
    pre = f"{key}." if key else ""
    for name in ("attention_0", "attention_1", "classifier",
                 "multimodal_projection"):
        _dense(p[name], pre + name, out)


def _transmil(p, out):
    for name in ("_fc1", "_fc2", "multimodal_projection"):
        _dense(p[name], name, out)
    out["cls_token"] = _np(p["cls_token"])
    _nystrom_layer(p["layer1"], "layer1", out)
    _ppeg(p["pos_layer"], "pos_layer", out)
    _nystrom_layer(p["layer2"], "layer2", out)
    _ln(p["norm"], "norm", out)


def _pathomic(p, bs, mode, out):
    if mode == "pathomic_original":
        _dense(p["path_net"], "path_net", out)
        _dense(p["path_classifier"], "path_classifier", out)
    else:
        _abmil(p["path_net"], "path_net", out)
    _maxnet(p["omic_net"], "omic_net", out)
    if "fusion" in p:
        _bilinear_fusion(p["fusion"], (bs or {}).get("fusion"), "fusion", out)
    for name in ("classifier", "ae_down", "ae_up"):
        if name in p:
            _dense(p[name], name, out)
    if "ae_norm" in p:
        _ln(p["ae_norm"], "ae_norm", out)


def _signatures(p, out):
    for name, sub in p.items():
        if name.startswith("sig_"):
            _dense(sub["fc"], f"{name}.fc", out)


def _mcat_cmta_head(p, bs, out):
    _dense(p["wsi_net"], "wsi_net", out)
    _signatures(p, out)
    if "mm" in p:
        _bilinear_fusion(p["mm"], (bs or {}).get("mm"), "mm", out)
    else:
        _dense(p["mm_0"], "mm_0", out)
        _dense(p["mm_1"], "mm_1", out)
    _dense(p["classifier"], "classifier", out)


def _mcat(p, bs, out):
    _mcat_cmta_head(p, bs, out)
    _mha(p["coattn"], "coattn", out)
    for prefix in ("path", "omic"):
        for i in range(2):
            t, key = p[f"{prefix}_transformer_{i}"], f"{prefix}_transformer_{i}"
            _mha(t["self_attn"], f"{key}.self_attn", out)
            for name in ("norm1", "norm2"):
                _ln(t[name], f"{key}.{name}", out)
            for name in ("linear1", "linear2"):
                _dense(t[name], f"{key}.{name}", out)
        head = p[f"{prefix}_attention_head"]
        for name in ("attention_a", "attention_b", "attention_c"):
            _dense(head[name], f"{prefix}_attention_head.{name}", out)
        _dense(p[f"{prefix}_rho"], f"{prefix}_rho", out)


def _cmta(p, bs, out):
    _mcat_cmta_head(p, bs, out)
    for name in ("P_in_G_Att", "G_in_P_Att"):
        _mha(p[name], name, out)
    for key in ("pathomics_encoder", "genomics_encoder", "pathomics_decoder",
                "genomics_decoder"):
        t = p[key]
        out[f"{key}.cls_token"] = _np(t["cls_token"])
        _nystrom_layer(t["layer1"], f"{key}.layer1", out)
        _nystrom_layer(t["layer2"], f"{key}.layer2", out)
        _ln(t["norm"], f"{key}.norm", out)
        if "pos_layer" in t:
            _ppeg(t["pos_layer"], f"{key}.pos_layer", out)


def _transfusion(p, key, out):
    _ln(p["norm"], f"{key}.norm", out)
    _mha(p["multihead_attn"], f"{key}.multihead_attn", out)
    _dense(p["pooler"]["dense"], f"{key}.pooler.dense", out)


def _teacher_net(p, key, out):
    _dense(p["_fc1"], f"{key}._fc1.0", out)
    enc = p["encoder"]
    _ln(enc["norm"], f"{key}.encoder.norm", out)
    _attn2d(enc["attn2d_omic1"], f"{key}.encoder.attn2d_omic1", out)
    _attn2d(enc["attn2d_omic2"], f"{key}.encoder.attn2d_omic2", out)
    _dense(enc["fusion_layer"]["fusion_layer"],
           f"{key}.encoder.fusion_layer.fusion_layer", out)
    _transfusion(enc["transfusion_layer1"],
                 f"{key}.encoder.transfusion_layer1", out)
    _transfusion(enc["transfusion_layer2"],
                 f"{key}.encoder.transfusion_layer2", out)
    _ln(p["norm"], f"{key}.norm", out)
    _dense(p["pooler1"]["dense"], f"{key}.pooler1.dense", out)
    _dense(p["pooler2"]["dense"], f"{key}.pooler2.dense", out)
    _dense(p["classifier"], f"{key}.classifier", out)


def _student_net(p, key, out):
    _dense(p["_fc1"], f"{key}._fc1.0", out)
    enc = p["encoder"]
    _ln(enc["norm"], f"{key}.encoder.norm", out)
    _attn2d(enc["attn2d"], f"{key}.encoder.attn2d", out)
    _ln(enc["cluster_merge"]["norm"], f"{key}.encoder.cluster_merge.norm", out)
    _dense(enc["cluster_merge"]["score"],
           f"{key}.encoder.cluster_merge.score", out)
    _dense(p["classifier"], f"{key}.classifier", out)


def _deform_mil(p, key, out, attn_dim):
    _dense(p["_fc1"], f"{key}._fc1.0", out)
    _dense(p["fusion_layer"]["fusion_layer"],
           f"{key}.fusion_layer.fusion_layer", out)
    _ln(p["layer3"]["norm"], f"{key}.layer3.norm", out)
    if attn_dim == 2:
        _attn2d(p["layer3"]["attn2d"], f"{key}.layer3.attn2d", out)
        _dense(p["pooler"]["dense"], f"{key}.pooler.dense", out)
    else:
        _attn1d(p["layer3"]["attn1d"], f"{key}.layer3.attn1d", out)
        out[f"{key}.cls_token"] = _np(p["cls_token"])
    _ln(p["norm"], f"{key}.norm", out)
    _dense(p["_fc2"], f"{key}._fc2", out)
    _dense(p["multimodal_projection"], f"{key}.multimodal_projection", out)


def _dense_children(p, out, pre=""):
    for name, sub in p.items():
        _dense(sub, pre + name, out)


def _feed_forward(p, key, out):
    _dense_children(p, out, f"{key}." if key else "")


def _cross_att(p, out):
    _ln(p["norm"], "norm", out)
    _mha(p["multihead_attn"], "multihead_attn", out)


def _nystromformer(p, out):
    for name, sub in p.items():
        if "norm" in name:
            _ln(sub, name, out)
        elif name.startswith("attn_"):
            _nystrom_attention(sub, name, out)
        else:
            _feed_forward(sub, name, out)


def _trilinear_fusion(p, out):
    for name, sub in p.items():
        if name.startswith("bilinear_"):
            out[name] = _np(sub)
        else:
            _dense(sub, name, out)


_MODULES = {"GatedABMIL": lambda p, bs, out: _dense_children(p, out),
            "TrilinearFusion": lambda p, bs, out: _trilinear_fusion(p, out),
            "BilinearFusion": lambda p, bs, out: _bilinear_fusion(p, bs, "",
                                                                  out),
            "FeedForward": lambda p, bs, out: _feed_forward(p, "", out),
            "CrossAttLayer": lambda p, bs, out: _cross_att(p, out),
            "Nystromformer": lambda p, bs, out: _nystromformer(p, out)}


def jax_module_state_dict(params, module: str, batch_stats=None) -> dict:
    """The params of one JAX module (``GatedABMIL``, ``TrilinearFusion``,
    ``FeedForward``, ``CrossAttLayer`` and ``Nystromformer``, which no mode
    builds, or a ``BilinearFusion`` with its ``batch_stats``) -> the
    state_dict of the port's module of that name (flax names, as the
    baselines'), as numpy arrays."""
    if module not in _MODULES:
        raise ValueError(f"module {module!r}: the port maps JAX params of "
                         f"{', '.join(_MODULES)}")
    out: dict = {}
    _MODULES[module](params, batch_stats, out)
    return out


def jax_state_dict(params, mode: str, attn_dim: int = 2,
                   batch_stats=None) -> dict:
    """A JAX param tree of ``mode`` (``teacher``, ``uniteacher``,
    ``student``, ``multiscale``, ``deformpathomic`` at ``attn_dim``,
    unstacked, or a baseline) and, for a model with BatchNorm
    (BilinearFusion), its ``batch_stats`` -> reference-named (baselines:
    flax-named) state_dict of numpy arrays; a tree in the
    ``stacked_scales`` layout is unstacked first."""
    params = unstack_scale_params(dict(params))
    out: dict = {}
    if mode in ("teacher", "uniteacher"):
        _maxnet(params["omic_net_tumor"], "omic_net_tumor", out)
        _maxnet(params["omic_net_immune"], "omic_net_immune", out)
        _teacher_net(params["teacher10_net"], "teacher10_net", out)
        _teacher_net(params["teacher20_net"], "teacher20_net", out)
    elif mode == "student":
        _student_net(params["student10_net"], "student10_net", out)
        _student_net(params["student20_net"], "student20_net", out)
    elif mode == "multiscale":
        for key in ("scale10_net", "scale20_net"):
            p = params[key]
            _maxnet(p["omic_net_tumor"], f"{key}.omic_net_tumor", out)
            _maxnet(p["omic_net_immune"], f"{key}.omic_net_immune", out)
            _student_net(p["student_net"], f"{key}.student_net", out)
            _teacher_net(p["teacher_net"], f"{key}.teacher_net", out)
    elif mode == "deformpathomic":
        _maxnet(params["omic_net_tumor"], "omic_net_tumor", out)
        _maxnet(params["omic_net_immune"], "omic_net_immune", out)
        for key in ("pathomic_net_tumor", "pathomic_net_immune"):
            _deform_mil(params[key], key, out, attn_dim)
        if "fusion" in params:
            _bilinear_fusion(params["fusion"], (batch_stats or {}).get(
                "fusion"), "fusion", out)
        _dense(params["classifier"], "classifier", out)
        _dense(params["classifier_tumor"], "classifier_tumor.0", out)
        _dense(params["classifier_immune"], "classifier_immune.0", out)
        # the reference's constant members (models/model.py:509-510)
        out["output_range"] = np.asarray([6.0], np.float32)
        out["output_shift"] = np.asarray([-3.0], np.float32)
    elif mode == "path":
        _abmil(params, "", out)
    elif mode == "transmil":
        _transmil(params, out)
    elif mode == "omic":
        _maxnet(params, "", out)
    elif mode in ("pathomic", "pathomic_original", "pathomic_fg",
                  "pathomic_ensemble"):
        _pathomic(params, batch_stats, mode, out)
    elif mode == "mcat":
        _mcat(params, batch_stats, out)
    elif mode == "cmta":
        _cmta(params, batch_stats, out)
    else:
        raise ValueError(f"mode {mode!r}: the port loads JAX params of the "
                         "teacher, uniteacher, student, multiscale, "
                         "deformpathomic and baseline modes")
    return out


def load_jax_params(model: torch.nn.Module, params, mode: str,
                    attn_dim: int = 2, batch_stats=None):
    """Load a JAX param tree of ``mode`` (see :func:`jax_state_dict`)."""
    sd = {k: torch.from_numpy(np.array(v, dtype=np.float32))
          for k, v in jax_state_dict(params, mode, attn_dim,
                                     batch_stats).items()}
    model.load_state_dict(sd, strict=True)
    return model

