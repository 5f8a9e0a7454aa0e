"""Weights: the bridge from the JAX package's flax variables, and a seeded init.

`load_jax_variables` loads a flax variables tree ({"params": ...,
"batch_stats": ...} as nested dicts of numpy arrays) into the port's
modules.  The flax module names are pinned in the JAX package, so the
mapping is a fixed table per module class (`_children`), and the layout
rules are those of `satmvs_tpu/train/convert.py`, reversed:

  flax Conv kernel (kh, kw, I, O)                → Conv2d weight (O, I, kh, kw)
  flax ConvTranspose kernel (kh, kw, O, I)
      (transpose_kernel=True)                    → ConvTranspose2d weight (I, O, kh, kw)
  3-D (CostRegNet's Conv3DVia2D, ConvTranspose3DVia2D): the same with a
      leading kd, (kd, kh, kw, I, O) → Conv3d (O, I, kd, kh, kw) and
      (kd, kh, kw, O, I) → ConvTranspose3d (I, O, kd, kh, kw), depth taps
      in the same order (flax's k[t] is torch's [:, :, t]; no flip)
  BatchNorm scale/bias, batch_stats mean/var     → weight/bias, running_mean/running_var
  GroupNorm scale/bias                           → weight/bias

A key the model has no place for, or a parameter the tree does not fill,
raises.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from .nn.blocks import ConvBlock, ConvGRUCell, DeconvBlock, DeconvFuse
from .nn.costreg import CostRegNet
from .nn.featurenet import FeatureNet
from .nn.red import REDRegularizer, REDStep


def _children(module: nn.Module) -> dict[str, nn.Module]:
    """flax child name → port submodule, for every container module."""
    from .models.cascade import CascadeModel  # models imports this module

    if isinstance(module, CascadeModel):
        out = {"FeatureNet_0": module.feature}
        prefix = "REDRegularizer" if module.regularizer == "red" else "CostRegNet"
        out.update({f"{prefix}_{i}": r for i, r in enumerate(module.regs)})
        return out
    if isinstance(module, FeatureNet):
        blocks = [*module.conv0, *module.conv1, *module.conv2]
        out = {f"ConvBlock_{i}": m for i, m in enumerate(blocks)}
        if module.num_stage == 1:  # the encoder and the 1/4-resolution head alone
            out["Conv_0"] = module.out1
        elif module.arch_mode == "fpn":
            out.update({"Conv_0": module.out1, "Conv_1": module.inner1, "Conv_2": module.out2,
                        "Conv_3": module.inner2, "Conv_4": module.out3})
        else:
            out.update({"Conv_0": module.out1, "DeconvFuse_0": module.deconv1,
                        "Conv_1": module.out2, "DeconvFuse_1": module.deconv2,
                        "Conv_2": module.out3})
        return out
    if isinstance(module, CostRegNet):
        out = {f"ConvBlock_{i}": m for i, m in enumerate(module.convs)}
        out.update({f"DeconvBlock_{i}": m for i, m in enumerate(module.deconvs)})
        out["Conv_0"] = module.head
        return out
    if isinstance(module, DeconvFuse):
        return {"DeconvBlock_0": module.deconv, "ConvBlock_0": module.conv}
    if isinstance(module, (ConvBlock, DeconvBlock)):
        conv_name = "ConvTranspose_0" if isinstance(module, DeconvBlock) else "Conv_0"
        out = {conv_name: module.conv}
        if module.bn is not None:
            out["BatchNorm_0"] = module.bn
        return out
    if isinstance(module, REDRegularizer):
        return {"ScanREDStep_0": module.step}
    if isinstance(module, REDStep):
        # flax creation order: encoder, then coarse → fine GRU/deconv pairs
        m = module
        return {"ConvBlock_0": m.enc1, "ConvBlock_1": m.enc2, "ConvBlock_2": m.enc3,
                "ConvGRUCell_0": m.gru4, "DeconvBlock_0": m.up3,
                "ConvGRUCell_1": m.gru3, "DeconvBlock_1": m.up2,
                "ConvGRUCell_2": m.gru2, "DeconvBlock_2": m.up1,
                "ConvGRUCell_3": m.gru1, "Conv_0": m.head}
    if isinstance(module, ConvGRUCell):
        return {"Conv_x": module.conv_x, "Conv_h": module.conv_h, "Conv_c": module.conv_c,
                "GroupNorm_0": module.gn_r, "GroupNorm_1": module.gn_u,
                "GroupNorm_2": module.gn_y}
    raise TypeError(f"no flax name table for {type(module).__name__}")


_CONVS = (nn.Conv2d, nn.ConvTranspose2d, nn.Conv3d, nn.ConvTranspose3d)
_LEAVES = (*_CONVS, nn.BatchNorm2d, nn.GroupNorm)


def _leaf_tensors(module: nn.Module, params: dict, stats: dict, path: str):
    """[(port tensor, numpy value)] of one leaf module (one of _LEAVES);
    raises on a key set that does not match the module."""
    conv = isinstance(module, _CONVS)
    bn = isinstance(module, nn.BatchNorm2d)
    if conv:
        want_p = {"kernel"} | ({"bias"} if module.bias is not None else set())
    else:
        want_p = {"scale", "bias"}
    want_s = {"mean", "var"} if bn else set()
    if set(params) != want_p or set(stats) != want_s:
        raise KeyError(f"{path}: keys params={sorted(params)} batch_stats={sorted(stats)}, "
                       f"want params={sorted(want_p)} batch_stats={sorted(want_s)}")
    if conv:
        # both flax layouts map to torch by the same axis order: the two
        # channel axes, last first, then the spatial taps in order
        k = np.asarray(params["kernel"])
        pairs = [(module.weight, k.transpose(k.ndim - 1, k.ndim - 2, *range(k.ndim - 2)))]
        if module.bias is not None:
            pairs.append((module.bias, params["bias"]))
        return pairs
    pairs = [(module.weight, params["scale"]), (module.bias, params["bias"])]
    if bn:
        pairs += [(module.running_mean, stats["mean"]), (module.running_var, stats["var"])]
    return pairs


def _walk(module: nn.Module, params: dict, stats: dict, path: str, out: list):
    if isinstance(module, _LEAVES):
        out.extend(_leaf_tensors(module, params, stats, path))
        return
    children = _children(module)
    unused = (set(params) | set(stats)) - set(children)
    if unused:
        raise KeyError(f"{path or '/'}: unused flax keys {sorted(unused)}")
    for name, child in children.items():
        _walk(child, params.get(name, {}), stats.get(name, {}), f"{path}/{name}", out)


@torch.no_grad()
def load_jax_variables(model: nn.Module, variables: dict) -> nn.Module:
    """Load a flax variables tree (nested dicts of numpy arrays) into `model`
    in place; returns the model."""
    pairs: list = []
    _walk(model, variables.get("params", {}), variables.get("batch_stats", {}), "", pairs)
    if set(variables) - {"params", "batch_stats"}:
        raise KeyError(f"unused flax collections {sorted(set(variables) - {'params', 'batch_stats'})}")
    filled = set()
    for tensor, value in pairs:
        arr = torch.as_tensor(np.array(value, dtype=np.float32))
        if tuple(arr.shape) != tuple(tensor.shape):
            raise ValueError(f"shape {tuple(arr.shape)} does not fit {tuple(tensor.shape)}")
        tensor.copy_(arr)
        filled.add(id(tensor))
    _check_all_filled(model, filled)
    return model


def _check_all_filled(model: nn.Module, filled: set):
    tensors = list(model.named_parameters()) + [
        (n, b) for n, b in model.named_buffers() if not n.endswith("num_batches_tracked")]
    missing = [n for n, t in tensors if id(t) not in filled]
    if missing:
        raise KeyError(f"parameters not filled by the flax tree: {missing}")


@torch.no_grad()
def init_from_seed(model: nn.Module, seed: int) -> nn.Module:
    """Seeded weights from numpy: He-normal convolution kernels (2-D and
    3-D), zero conv biases, identity norms (scale 1, shift 0, running mean
    0 / var 1)."""
    rng = np.random.default_rng(seed)
    for module in model.modules():
        if isinstance(module, _CONVS):
            fan_in = module.in_channels * int(np.prod(module.kernel_size))
            if isinstance(module, (nn.ConvTranspose2d, nn.ConvTranspose3d)):
                fan_in //= int(np.prod(module.stride))
            w = rng.normal(0.0, np.sqrt(2.0 / fan_in), tuple(module.weight.shape))
            module.weight.copy_(torch.as_tensor(w, dtype=torch.float32))
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, (nn.BatchNorm2d, nn.GroupNorm)):
            module.weight.fill_(1.0)
            module.bias.zero_()
            if isinstance(module, nn.BatchNorm2d):
                module.running_mean.zero_()
                module.running_var.fill_(1.0)
    return model
