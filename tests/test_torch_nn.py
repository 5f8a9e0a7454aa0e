"""Port network modules against their flax counterparts, weights carried by
the bridge (satmvs_tpu_torch.params.load_jax_variables), on the CPU.

BatchNorm running statistics and every norm scale/shift are first set to
seeded non-trivial values, so a mix-up in the bridge's mapping shows."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from satmvs_tpu.nn import blocks as jblocks
from satmvs_tpu.nn.featurenet import FeatureNet as JFeatureNet
from satmvs_tpu.nn.red import REDRegularizer as JRED
from satmvs_tpu_torch.nn import blocks as tblocks
from satmvs_tpu_torch.nn.featurenet import FeatureNet as TFeatureNet
from satmvs_tpu_torch.nn.red import REDRegularizer as TRED
from satmvs_tpu_torch.params import load_jax_variables


def perturbed(variables, seed=0):
    """numpy copy of a flax variables tree with norm parameters and running
    statistics replaced by seeded non-trivial values."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for k, x in tree.items():
            if isinstance(x, dict):
                out[k] = walk(x)
            elif k == "scale":
                out[k] = (1.0 + 0.2 * rng.normal(size=x.shape)).astype(np.float32)
            elif k in ("bias", "mean"):
                out[k] = (0.1 * rng.normal(size=x.shape)).astype(np.float32)
            elif k == "var":
                out[k] = rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
            else:
                out[k] = np.array(x)
        return out

    return walk(jax.tree.map(np.asarray, dict(variables)))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _input(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("norm,stride,k", [("bn", 1, 3), ("none", 2, 3), ("bn", 2, 5)])
def test_conv_block_matches_flax(norm, stride, k):
    """Eval-mode ConvBlock (conv → BN with running stats → ReLU): 1e-5."""
    x = _input((2, 12, 16, 5))
    jm = jblocks.ConvBlock(7, k, stride=stride, norm=norm)
    v = perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = load_jax_variables(tblocks.ConvBlock(5, 7, k, stride, norm=norm), v).eval()
    got = nhwc(tm(nchw(x)))
    print(f"[parity] ConvBlock {norm} s{stride} k{k}: {np.abs(got - want).max():.2e} (tol 1e-5)")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("norm", ["none", "bn"])
def test_deconv_block_matches_flax(norm):
    """Stride-2 transposed conv with torch-exact padding: the flax kernel
    (kh, kw, O, I) with transpose_kernel=True becomes ConvTranspose2d's
    (I, O, kh, kw) without a spatial flip: 1e-5."""
    x = _input((2, 6, 10, 6))
    jm = jblocks.DeconvBlock(4, 3, norm=norm, use_bias=False)
    v = perturbed(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = load_jax_variables(tblocks.DeconvBlock(6, 4, norm=norm, use_bias=False), v).eval()
    got = nhwc(tm(nchw(x)))
    assert got.shape == want.shape == (2, 12, 20, 4)
    print(f"[parity] DeconvBlock {norm}: {np.abs(got - want).max():.2e} (tol 1e-5)")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_conv_gru_cell_matches_flax():
    """One GRU step (flax concat-conv form vs the port's split x/h form),
    GroupNorm(1): torch normalizes with another variance formula than
    flax's E[x²] − E[x]², so 1e-5 on outputs in (−1, 1)."""
    x = _input((2, 8, 12, 5), 2)
    h = np.tanh(_input((2, 8, 12, 4), 3))
    jm = jblocks.ConvGRUCell(4)
    v = perturbed(jm.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(h)))
    want, _ = jm.apply(v, jnp.asarray(x), jnp.asarray(h))
    tm = load_jax_variables(tblocks.ConvGRUCell(5, 4), v)
    got = nhwc(tm(nchw(x), nchw(h)))
    print(f"[parity] ConvGRUCell: {np.abs(got - np.asarray(want)).max():.2e} (tol 1e-5)")
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def test_featurenet_matches_flax():
    """unet FeatureNet in eval mode, all three outputs (channels-last): 1e-4
    on features of magnitude ~1-10 after 12 conv layers."""
    x = _input((2, 32, 48, 3), 4)
    jm = JFeatureNet(8, 3, "unet")
    v = perturbed(jm.init(jax.random.PRNGKey(3), jnp.asarray(x)))
    want = jm.apply(v, jnp.asarray(x), False)
    tm = load_jax_variables(TFeatureNet(8), v).eval()
    got = tm(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        print(f"[parity] FeatureNet {w.shape}: "
              f"{np.abs(g.detach().numpy() - np.asarray(w)).max():.2e} (tol 1e-4)")
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0, atol=1e-4)


def test_red_regularizer_matches_flax_scan_path():
    """(B, D, H, W, C) volume → logits, against flax REDRegularizer with
    fused=False (its lax.scan path): 1e-4 on logits of magnitude ~1."""
    vol = np.abs(_input((2, 5, 16, 24, 8), 5))
    jm = JRED(8)
    v = perturbed(jm.init(jax.random.PRNGKey(4), jnp.asarray(vol)))
    want = np.asarray(jm.apply(v, jnp.asarray(vol), False))
    tm = load_jax_variables(TRED(8, 8), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(vol)).numpy()
    assert got.shape == want.shape == (2, 5, 16, 24)
    print(f"[parity] REDRegularizer: {np.abs(got - want).max():.2e} (tol 1e-4)")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_bridge_rejects_missing_and_unused_keys():
    x = _input((1, 8, 8, 3))
    jm = jblocks.ConvBlock(4, 3, norm="bn")
    v = perturbed(jm.init(jax.random.PRNGKey(5), jnp.asarray(x)))
    extra = {"params": {**v["params"], "Conv_9": v["params"]["Conv_0"]},
             "batch_stats": v["batch_stats"]}
    with pytest.raises(KeyError, match="unused"):
        load_jax_variables(tblocks.ConvBlock(3, 4), extra)
    with pytest.raises(KeyError, match="want"):  # running statistics missing
        load_jax_variables(tblocks.ConvBlock(3, 4), {"params": v["params"]})
    with pytest.raises(KeyError, match="want"):  # a whole child missing
        load_jax_variables(tblocks.ConvBlock(3, 4), {"params": {"BatchNorm_0": v["params"]["BatchNorm_0"]},
                                                     "batch_stats": v["batch_stats"]})
    with pytest.raises(KeyError, match="want"):  # the port's conv has a bias
        load_jax_variables(tblocks.ConvBlock(3, 4, use_bias=True), v)
