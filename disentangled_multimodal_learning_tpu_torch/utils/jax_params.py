"""JAX params (as numpy) into the port, loaded with ``strict=True`` (a
reference-named ``.pth`` state_dict loads through ``utils/checkpoint.py``).

JAX params go through the port's own name map below (a copy of the JAX
package's numpy-only exporter ``utils/torch_export.py``, so that the port
imports nothing of that package): it writes the reference's names and torch
layouts, which the port's modules carry.  The map covers the modes the port
has, in the unstacked layout.  The reference's members that its forward
never uses (StudentNet's ``norm`` and ``pooler1``, the attention of the
other ``attn_dim`` in ``DeformCrossTransLayer``) have no counterpart in
the port, so the load stays strict.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(v):
    return np.asarray(v, dtype=np.float32)


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
    for i in range(4):
        _dense(p[f"encoder_{i}"], f"{key}.encoder.{i}.0", out)
    if "classifier" in p:
        _dense(p["classifier"], f"{key}.classifier.0", out)


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


def jax_state_dict(params, mode: str, attn_dim: int = 2) -> dict:
    """A JAX param tree of ``mode`` (``teacher``, ``uniteacher``,
    ``student``, ``multiscale`` or ``deformpathomic`` at ``attn_dim``,
    unstacked) ->
    reference-named state_dict of numpy arrays."""
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
        _dense(params["classifier"], "classifier", out)
        _dense(params["classifier_tumor"], "classifier_tumor.0", out)
        _dense(params["classifier_immune"], "classifier_immune.0", out)
        # the reference's constant members (models/model.py:509-510)
        out["output_range"] = np.asarray([6.0], np.float32)
        out["output_shift"] = np.asarray([-3.0], np.float32)
    else:
        raise ValueError(f"mode {mode!r}: the port loads JAX params of the "
                         "teacher, uniteacher, student, multiscale and "
                         "deformpathomic modes")
    return out


def load_jax_params(model: torch.nn.Module, params, mode: str,
                    attn_dim: int = 2):
    """Load a JAX param tree of ``mode`` (see :func:`jax_state_dict`)."""
    sd = {k: torch.from_numpy(np.array(v, dtype=np.float32))
          for k, v in jax_state_dict(params, mode, attn_dim).items()}
    model.load_state_dict(sd, strict=True)
    return model

