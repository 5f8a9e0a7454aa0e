"""The port's plane convolutions (satmvs_tpu_torch/ops/kernels/plane_conv.py)
against the JAX package's Pallas kernels (ops/pallas/plane_conv.py) in
interpret mode, through their NHWC wrappers, on the CPU.

Weights are drawn in flax layout with numpy and bridged by the rule of
satmvs_tpu_torch/params.py: a flax Conv kernel (kh, kw, I, O) and a flax
ConvTranspose kernel (kh, kw, O, I) both become torch weights by the axis
order (3, 2, 0, 1)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from satmvs_tpu.ops.pallas import plane_conv as pc
from satmvs_tpu_torch.ops.kernels.plane_conv import (
    conv_dn, conv_dn_reference, conv_head, conv_head_reference, deconv_up, deconv_up_reference)

D = 3


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _torch_weight(k):
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


def _jax_conv_dn(x, k):
    h, w = x.shape[1:3]
    xe, xo = pc.split_cols(pc.pack_planes(jnp.asarray(x)))
    return np.asarray(pc.unpack_planes(pc.conv_dn(xe, xo, jnp.asarray(k), h, w), h // 2, w // 2))


def _jax_deconv_up(x, kt):
    h, w = x.shape[1:3]
    ye, yo = pc.deconv_up(pc.pack_planes(jnp.asarray(x)), jnp.asarray(kt), h, w)
    return np.asarray(pc.unpack_planes(pc.merge_cols(ye, yo), 2 * h, 2 * w))


def _jax_conv_head(x, k, b):
    h, w = x.shape[1:3]
    out = pc.conv_head(pc.pack_planes(jnp.asarray(x)), jnp.asarray(k), jnp.asarray(b), h, w)
    return np.asarray(pc.unpack_planes(out, h, w))


def _compare(name, got, want, tol=1e-5):
    got = got.numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    print(f"[parity] {name}: {np.abs(got - want).max():.2e} (tol {tol})")
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_conv_dn_matches_pallas():
    """Stride-2 conv + ReLU, (16, 24, 8) → (8, 12, 16): 1e-5."""
    x, k = _rand((D, 16, 24, 8), 0), _rand((3, 3, 8, 16), 1, 0.2)
    got = conv_dn(torch.from_numpy(x), _torch_weight(k))
    _compare("conv_dn", got, _jax_conv_dn(x, k))


@pytest.mark.parametrize("h,w,cin,cout", [(8, 12, 16, 8), (5, 7, 8, 4)])
def test_deconv_up_matches_pallas(h, w, cin, cout):
    """torch-exact stride-2 transposed conv + ReLU at even and odd input sizes,
    and the fused skip add (relu first, then + skip): 1e-5."""
    x, kt = _rand((D, h, w, cin), 2), _rand((3, 3, cout, cin), 3, 0.2)
    skip = _rand((D, 2 * h, 2 * w, cout), 4)
    want = _jax_deconv_up(x, kt)
    wt = _torch_weight(kt)
    _compare(f"deconv_up {h}x{w}", deconv_up(torch.from_numpy(x), wt), want)
    _compare(f"deconv_up {h}x{w} + skip",
             deconv_up(torch.from_numpy(x), wt, torch.from_numpy(skip)), want + skip)


def test_conv_head_matches_pallas():
    """Stride-1 conv + bias, 8 → 1 channels: 1e-5."""
    x, k, b = _rand((D, 16, 24, 8), 5), _rand((3, 3, 8, 1), 6, 0.2), _rand((1,), 7)
    got = conv_head(torch.from_numpy(x), _torch_weight(k), torch.from_numpy(b))
    _compare("conv_head", got, _jax_conv_head(x, k, b))


def test_cpu_tensors_take_the_plain_versions():
    """CPU tensors never reach a kernel: the counters stay, and each wrapper
    returns its plain version's result exactly, channels-last and contiguous."""
    x = torch.from_numpy(_rand((2, 6, 10, 4), 8))
    wd = torch.from_numpy(_rand((8, 4, 3, 3), 9))
    wu = torch.from_numpy(_rand((4, 3, 3, 3), 10))
    wh, bh = torch.from_numpy(_rand((1, 4, 3, 3), 11)), torch.from_numpy(_rand((1,), 12))
    counts = (conv_dn.launches, deconv_up.launches, conv_head.launches)
    pairs = [(conv_dn(x, wd), conv_dn_reference(x, wd), (2, 3, 5, 8)),
             (deconv_up(x, wu), deconv_up_reference(x, wu), (2, 12, 20, 3)),
             (conv_head(x, wh, bh), conv_head_reference(x, wh, bh), (2, 6, 10, 1))]
    assert (conv_dn.launches, deconv_up.launches, conv_head.launches) == counts == (0, 0, 0)
    for got, want, shape in pairs:
        assert tuple(got.shape) == shape and got.is_contiguous()
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros((2, 6, 10, 4))
    w = torch.zeros((8, 4, 3, 3))
    with pytest.raises(TypeError):
        conv_dn(x.double(), w)
    with pytest.raises(ValueError):
        conv_dn(x[..., :3], w)  # channels do not match the weight
    with pytest.raises(ValueError):
        conv_dn(x, torch.zeros((8, 4, 5, 5)))
    with pytest.raises(ValueError):
        conv_head(x, w, torch.zeros(3))
    with pytest.raises(ValueError):
        deconv_up(x, torch.zeros((4, 3, 3, 3)), torch.zeros((2, 12, 20, 4)))
