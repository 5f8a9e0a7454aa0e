"""Reference (PyTorch SatMVS) checkpoint → flax-named parameter tree.

The port's own copy of `satmvs_tpu/train/convert.py` (numpy, for the three
families): it turns the reference's `torch.save({'model': state_dict,
...})` checkpoints into the variables tree the JAX package's models take,
`{"params", "batch_stats"}` under flax's module names, which
`params.load_jax_variables` loads into the port's `CascadeModel`
(`cli.convert_ckpt` writes it as a port checkpoint).  A converted
checkpoint was trained under the reference's sampling: run it with
`torch_compat=True` (`models.cascade`).

Weight-layout rules:
  Conv2d/3d           (O, I, *k)      → kernel (*k, I, O)
  ConvTranspose2d/3d  (I, O, *k)      → kernel (*k, O, I)   (the flax
                        DeconvBlock's transpose_kernel=True with torch-exact
                        padding)
  stride-1 ConvTranspose2d (the RED head) ≡ plain conv with the spatially
                        flipped, (I, O)-swapped kernel → the Conv head
  BatchNorm           weight/bias → scale/bias; running stats → batch_stats
  GroupNorm           weight/bias → scale/bias   (ε 1e-5)

Naming: explicit per-architecture tables map the reference's module paths
(DataParallel's "module." prefix stripped) onto the flax module tree.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def _conv(sd, prefix):
    out = {"kernel": _t_conv(sd[prefix + ".weight"])}
    if prefix + ".bias" in sd:
        out["bias"] = np.asarray(sd[prefix + ".bias"])
    return out


def _t_conv(w):
    w = np.asarray(w)
    # (O, I, *k) → (*k, I, O)
    nd = w.ndim
    return w.transpose(*range(2, nd), 1, 0)


def _t_deconv(w):
    w = np.asarray(w)
    # (I, O, *k) → (*k, O, I) for transpose_kernel=True
    nd = w.ndim
    return w.transpose(*range(2, nd), 1, 0)


def _deconv(sd, prefix):
    out = {"kernel": _t_deconv(sd[prefix + ".weight"])}
    if prefix + ".bias" in sd:
        out["bias"] = np.asarray(sd[prefix + ".bias"])
    return out


def _deconv_as_conv(sd, prefix):
    """Stride-1 ConvTranspose ≡ conv with flipped kernel (the RED head)."""
    w = np.asarray(sd[prefix + ".weight"])  # (I, O, kh, kw)
    w = w[:, :, ::-1, ::-1].transpose(0, 1, 2, 3)  # flip spatial
    w = w.transpose(1, 0, 2, 3)  # → (O, I, kh, kw)
    out = {"kernel": _t_conv(w)}
    if prefix + ".bias" in sd:
        out["bias"] = np.asarray(sd[prefix + ".bias"])
    return out


def _norm(sd, prefix):
    return {
        "scale": np.asarray(sd[prefix + ".weight"]),
        "bias": np.asarray(sd[prefix + ".bias"]),
    }


def _bn_stats(sd, prefix):
    return {
        "mean": np.asarray(sd[prefix + ".running_mean"]),
        "var": np.asarray(sd[prefix + ".running_var"]),
    }


def _conv_block(sd, prefix) -> Tuple[dict, dict]:
    """Reference Conv2d/Conv3d/Deconv wrapper {conv, bn} → ConvBlock tree."""
    params = {"Conv_0": _conv(sd, prefix + ".conv")}
    stats = {}
    if prefix + ".bn.weight" in sd:
        params["BatchNorm_0"] = _norm(sd, prefix + ".bn")
        stats["BatchNorm_0"] = _bn_stats(sd, prefix + ".bn")
    return params, stats


def _deconv_block(sd, prefix) -> Tuple[dict, dict]:
    params = {"ConvTranspose_0": _deconv(sd, prefix + ".conv")}
    stats = {}
    if prefix + ".bn.weight" in sd:
        params["BatchNorm_0"] = _norm(sd, prefix + ".bn")
        stats["BatchNorm_0"] = _bn_stats(sd, prefix + ".bn")
    return params, stats


def _gru(sd, prefix) -> dict:
    """ConvGRUCell2 → ConvGRUCell (the reference's modules/module.py:6-58).

    The flax cell splits each concat-conv by linearity into x/h halves so the
    x-half hoists out of the RED depth scan: the torch gate_conv /
    output_conv kernels (input channels = [x | h]) are sliced along the
    input-channel axis; the x-slices pack into one 3C-output `Conv_x`
    ([gates-x | cand-x]); biases go to the h-side convs.  Exact:
    conv([x,h]) = conv_x(x) + conv_h(h) + b.
    """
    wg = _t_conv(sd[prefix + ".gate_conv.weight"])      # (kh, kw, Cx+Ch, 2Ch)
    wc = _t_conv(sd[prefix + ".output_conv.weight"])    # (kh, kw, Cx+Ch, Ch)
    ch = wc.shape[-1]
    cx = wg.shape[2] - ch
    return {
        "Conv_x": {"kernel": np.concatenate([wg[:, :, :cx], wc[:, :, :cx]], axis=-1)},
        "Conv_h": {"kernel": wg[:, :, cx:],
                   "bias": np.asarray(sd[prefix + ".gate_conv.bias"])},
        "Conv_c": {"kernel": wc[:, :, cx:],
                   "bias": np.asarray(sd[prefix + ".output_conv.bias"])},
        "GroupNorm_0": _norm(sd, prefix + ".reset_gate_norm"),
        "GroupNorm_1": _norm(sd, prefix + ".update_gate_norm"),
        "GroupNorm_2": _norm(sd, prefix + ".output_norm"),
    }


def convert_featurenet(sd: Dict, prefix: str = "feature", arch_mode: str = "unet",
                       num_stage: int = 3) -> Tuple[dict, dict]:
    """FeatureNet (module.py:442-543) → the flax FeatureNet tree."""
    p: dict = {}
    s: dict = {}

    def put(name, pair):
        params, stats = pair
        p[name] = params
        if stats:
            s[name] = stats

    # encoder: conv0.{0,1}, conv1.{0,1,2}, conv2.{0,1,2} → ConvBlock_0..7
    blocks = [f"{prefix}.conv0.0", f"{prefix}.conv0.1",
              f"{prefix}.conv1.0", f"{prefix}.conv1.1", f"{prefix}.conv1.2",
              f"{prefix}.conv2.0", f"{prefix}.conv2.1", f"{prefix}.conv2.2"]
    for i, b in enumerate(blocks):
        put(f"ConvBlock_{i}", _conv_block(sd, b))
    p["Conv_0"] = _conv(sd, f"{prefix}.out1")

    if num_stage >= 2:
        if arch_mode == "unet":
            dp, ds = _deconv_block(sd, f"{prefix}.deconv1.deconv")
            cp, cs = _conv_block(sd, f"{prefix}.deconv1.conv")
            p["DeconvFuse_0"] = {"DeconvBlock_0": dp, "ConvBlock_0": cp}
            s["DeconvFuse_0"] = {"DeconvBlock_0": ds, "ConvBlock_0": cs}
            p["Conv_1"] = _conv(sd, f"{prefix}.out2")
            if num_stage == 3:
                dp, ds = _deconv_block(sd, f"{prefix}.deconv2.deconv")
                cp, cs = _conv_block(sd, f"{prefix}.deconv2.conv")
                p["DeconvFuse_1"] = {"DeconvBlock_0": dp, "ConvBlock_0": cp}
                s["DeconvFuse_1"] = {"DeconvBlock_0": ds, "ConvBlock_0": cs}
                p["Conv_2"] = _conv(sd, f"{prefix}.out3")
        else:  # fpn
            p["Conv_1"] = _conv(sd, f"{prefix}.inner1")
            p["Conv_2"] = _conv(sd, f"{prefix}.out2")
            if num_stage == 3:
                p["Conv_3"] = _conv(sd, f"{prefix}.inner2")
                p["Conv_4"] = _conv(sd, f"{prefix}.out3")
    return p, s


def convert_red_step(sd: Dict, prefix: str) -> dict:
    """RED_Regularization / slice_RED_Regularization (module.py:595-693)
    → the flax REDStep tree (creation order: conv1-3, gru4, upconv3, gru3,
    upconv2, gru2, upconv1, gru1, head)."""
    p = {
        "ConvBlock_0": {"Conv_0": _conv(sd, f"{prefix}.conv1.conv")},
        "ConvBlock_1": {"Conv_0": _conv(sd, f"{prefix}.conv2.conv")},
        "ConvBlock_2": {"Conv_0": _conv(sd, f"{prefix}.conv3.conv")},
        "ConvGRUCell_0": _gru(sd, f"{prefix}.conv_gru4"),
        "DeconvBlock_0": {"ConvTranspose_0": _deconv(sd, f"{prefix}.upconv3.conv")},
        "ConvGRUCell_1": _gru(sd, f"{prefix}.conv_gru3"),
        "DeconvBlock_1": {"ConvTranspose_0": _deconv(sd, f"{prefix}.upconv2.conv")},
        "ConvGRUCell_2": _gru(sd, f"{prefix}.conv_gru2"),
        "DeconvBlock_2": {"ConvTranspose_0": _deconv(sd, f"{prefix}.upconv1.conv")},
        "ConvGRUCell_3": _gru(sd, f"{prefix}.conv_gru1"),
        "Conv_0": _deconv_as_conv(sd, f"{prefix}.upconv2d"),
    }
    return p


def convert_costreg(sd: Dict, prefix: str) -> Tuple[dict, dict]:
    """CostRegNet (module.py:546-577) → the flax CostRegNet tree."""
    p: dict = {}
    s: dict = {}
    conv_order = ["conv0", "conv1", "conv2", "conv3", "conv4", "conv5", "conv6"]
    for i, name in enumerate(conv_order):
        params, stats = _conv_block(sd, f"{prefix}.{name}")
        p[f"ConvBlock_{i}"] = params
        s[f"ConvBlock_{i}"] = stats
    for i, name in enumerate(["conv7", "conv9", "conv11"]):
        params, stats = _deconv_block(sd, f"{prefix}.{name}")
        p[f"DeconvBlock_{i}"] = params
        s[f"DeconvBlock_{i}"] = stats
    p["Conv_0"] = _conv(sd, f"{prefix}.prob")
    return p, s


def convert_reference_checkpoint(state_dict: Dict, model: str = "red",
                                 arch_mode: str | None = None,
                                 num_stage: int = 3) -> Tuple[dict, dict]:
    """Full reference state_dict → (params, batch_stats) for CascadeModel.

    Args:
      state_dict: torch state dict (tensors or numpy); "module." prefixes
        (DataParallel) are stripped.
      model: "red" | "casmvs" | "ucs".
      arch_mode: feature decoder mode; defaults per model (red/ucs: unet,
        casmvs: fpn).
    """
    sd = {}
    for k, v in state_dict.items():
        k = k[len("module."):] if k.startswith("module.") else k
        sd[k] = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)

    if arch_mode is None:
        arch_mode = "fpn" if model == "casmvs" else "unet"
    feat_prefix = "feature_extraction" if model == "ucs" else "feature"

    params: dict = {}
    stats: dict = {}
    fp, fs = convert_featurenet(sd, feat_prefix, arch_mode, num_stage)
    params["FeatureNet_0"] = fp
    stats["FeatureNet_0"] = fs

    for i in range(num_stage):
        prefix = f"cost_regularization.{i}"
        if model == "red":
            params[f"REDRegularizer_{i}"] = {
                "ScanREDStep_0": convert_red_step(sd, prefix)
            }
        else:
            cp, cs = convert_costreg(sd, prefix)
            params[f"CostRegNet_{i}"] = cp
            stats[f"CostRegNet_{i}"] = cs
    return params, stats


def load_reference_checkpoint(path: str, model: str = "red", **kw):
    """Load a reference .ckpt file (torch.save of {'model': state_dict, ...}
    or of the state dict itself) → (params, batch_stats).  The file is
    unpickled whole (weights_only=False, as the reference saves it): load
    only checkpoints you trust."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob["model"] if isinstance(blob, dict) and "model" in blob else blob
    return convert_reference_checkpoint(sd, model=model, **kw)


def reference_variables(path: str, model: str = "red", **kw) -> dict:
    """A reference .ckpt → the flax variables tree {"params", "batch_stats"}
    that `params.load_jax_variables` loads into the port's model."""
    params, stats = load_reference_checkpoint(path, model, **kw)
    return {"params": params, "batch_stats": stats}
