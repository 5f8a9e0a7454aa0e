"""The CostRegNet families' modules against the JAX package, on the CPU:

  * the plane convs' CostRegNet forms (conv_dn and deconv_up with relu off,
    conv_head 8 → 16 with a zero bias) against the Pallas kernels in
    interpret mode, 1e-5;
  * the 3-D ConvBlock / DeconvBlock against flax's `Conv3DVia2D` /
    `ConvTranspose3DVia2D` blocks through the weight bridge (this holds the
    transposed kernel's depth-tap order), 1e-5;
  * CostRegNet: the port's conv3d path and its packed path (the plain
    versions, relu off) against JAX `CostRegNet(fused=False)` at
    (1, 8, 16, 16, 5) in eval mode with non-trivial BatchNorm statistics,
    atol 1e-4 (JAX's own tolerance for packed against XLA); the train-mode
    forward and its running statistics against flax's train-mode apply;
  * the fpn FeatureNet, `window_prob_confidence`, `expected_variance` and
    `uncertainty_samples`.

Weights are numpy-seeded at LeCun scale in flax layout and carried across
with `params.load_jax_variables`; norms and statistics are perturbed
(scale 1 ± 0.2, bias and mean ± 0.1, var in [0.5, 1.5])."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satmvs_tpu.nn import blocks as jblocks
from satmvs_tpu.nn.costreg import CostRegNet as JCostRegNet
from satmvs_tpu.nn.featurenet import FeatureNet as JFeatureNet
from satmvs_tpu.ops import depth_range as jdr
from satmvs_tpu.ops import regression as jreg
from satmvs_tpu.ops.pallas import plane_conv as jpc
from satmvs_tpu_torch.nn.blocks import ConvBlock, DeconvBlock
from satmvs_tpu_torch.nn.costreg import CostRegNet
from satmvs_tpu_torch.nn.featurenet import FeatureNet
from satmvs_tpu_torch.ops import depth_range, regression
from satmvs_tpu_torch.ops.kernels import plane_conv as pc
from satmvs_tpu_torch.params import load_jax_variables


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the module's many small torch ops run beside
    other test processes, which several threads a process would oversubscribe."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _seeded(shapes, seed: int) -> dict:
    """A flax variables tree in the shapes of `shapes`: LeCun-scale kernels,
    perturbed norms and statistics."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            return rng.normal(0.0, 1.0 / np.sqrt(np.prod(s.shape[:-1])), s.shape)
        if name == "scale":
            return 1.0 + 0.2 * rng.normal(size=s.shape)
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape)
        return 0.1 * rng.normal(size=s.shape)  # bias, mean

    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(draw(p, s), np.float32), shapes)


def _compare(name, got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    print(f"[parity] {name}: {err:.2e} (tol {tol})")
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("form", ["conv_dn", "deconv_up", "conv_head"])
def test_costreg_plane_forms_match_pallas(form):
    """conv_dn relu off (16×24, 8 → 16), deconv_up relu off without a skip
    (8×12, 16 → 8) and conv_head 8 → 16 with a zero bias (16×24) against
    the Pallas kernels: 1e-5.  Negative outputs survive (no ReLU)."""
    d = 3
    if form == "conv_dn":
        x, k = _rand((d, 16, 24, 8), 0), _rand((3, 3, 8, 16), 1, 0.2)
        xe, xo = jpc.split_cols(jpc.pack_planes(jnp.asarray(x)))
        want = jpc.unpack_planes(jpc.conv_dn(xe, xo, jnp.asarray(k), 16, 24, relu=False), 8, 12)
        got = pc.conv_dn(torch.from_numpy(x), torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),
                         relu=False)
        plain = pc.conv_dn_reference(torch.from_numpy(x),
                                     torch.from_numpy(k.transpose(3, 2, 0, 1).copy()), relu=False)
    elif form == "deconv_up":
        x, kt = _rand((d, 8, 12, 16), 2), _rand((3, 3, 8, 16), 3, 0.2)
        ye, yo = jpc.deconv_up(jpc.pack_planes(jnp.asarray(x)), jnp.asarray(kt), 8, 12,
                               relu=False)
        want = jpc.unpack_planes(jpc.merge_cols(ye, yo), 16, 24)
        wt = torch.from_numpy(kt.transpose(3, 2, 0, 1).copy())
        got = pc.deconv_up(torch.from_numpy(x), wt, relu=False)
        plain = pc.deconv_up_reference(torch.from_numpy(x), wt, relu=False)
    else:
        x, k = _rand((d, 16, 24, 8), 4), _rand((3, 3, 8, 16), 5, 0.2)
        zb = np.zeros((16,), np.float32)
        want = jpc.unpack_planes(jpc.conv_head(jpc.pack_planes(jnp.asarray(x)), jnp.asarray(k),
                                               jnp.asarray(zb), 16, 24), 16, 24)
        wt = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
        got = pc.conv_head(torch.from_numpy(x), wt, torch.from_numpy(zb))
        plain = pc.conv_head_reference(torch.from_numpy(x), wt, torch.from_numpy(zb))
    want = np.asarray(want)
    assert (want < 0).mean() > 0.3
    _compare(form, got, want, 1e-5)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)  # CPU tensors: the plain version


def test_relu_off_is_forward_only():
    """relu=False refuses a graph (the packed form has no VJP, as in JAX);
    under no_grad it runs, and relu=True still differentiates."""
    x = torch.from_numpy(_rand((2, 8, 8, 4), 6))
    wd = torch.from_numpy(_rand((8, 4, 3, 3), 7)).requires_grad_()
    wu = torch.from_numpy(_rand((4, 8, 3, 3), 8)).requires_grad_()
    with pytest.raises(ValueError, match="forward-only"):
        pc.conv_dn(x, wd, relu=False)
    with pytest.raises(ValueError, match="forward-only"):
        pc.deconv_up(x, wu, relu=False)
    with torch.no_grad():
        assert (pc.conv_dn(x, wd, relu=False) < 0).any()
        assert (pc.deconv_up(x, wu, relu=False) < 0).any()
    pc.conv_dn(x, wd).sum().backward()
    assert wd.grad is not None


@pytest.mark.parametrize("kind", ["conv_s1", "conv_s2", "deconv"])
def test_3d_blocks_match_flax(kind):
    """ConvBlock(dims=3) at stride 1 and 2 and DeconvBlock(dims=3) against
    flax's blocks in eval mode, weights through the bridge: 1e-5.  The
    transposed block holds the bridge's depth-tap order (flax k[t] → torch
    weight[:, :, t]) against `ConvTranspose3DVia2D`'s even/odd planes."""
    x = _rand((1, 4, 6, 8, 5), 9)
    if kind == "deconv":
        jm, tm = jblocks.DeconvBlock(6, 3, dims=3), DeconvBlock(5, 6, dims=3)
    else:
        s = 1 if kind == "conv_s1" else 2
        jm, tm = jblocks.ConvBlock(6, 3, stride=s, dims=3), ConvBlock(5, 6, stride=s, dims=3)
    v = _seeded(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x)), 10)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    load_jax_variables(tm, v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    _compare(f"3-D {kind}", got, want, 1e-5)


COSTREG_SHAPE = (1, 8, 16, 16, 5)


@pytest.fixture(scope="module")
def costreg():
    """JAX CostRegNet(8, fused=False): a train-mode apply (its output and
    moved statistics), then eval with perturbed statistics; the port's
    CostRegNet with the same variables."""
    x = jnp.asarray(_rand(COSTREG_SHAPE, 11))
    jm = JCostRegNet(8, fused=False)
    v = _seeded(jax.eval_shape(lambda r, t: jm.init(r, t, False), jax.random.PRNGKey(0), x), 12)
    train_out, moved = jax.jit(lambda v, x: jm.apply(v, x, True, mutable=["batch_stats"]))(v, x)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, False))(v, x))
    tm = load_jax_variables(CostRegNet(5, 8), v).eval()
    return {"x": np.array(x), "v": v, "want": want, "train_out": np.asarray(train_out),
            "moved": jax.tree.map(np.asarray, moved["batch_stats"]), "model": tm}


@pytest.mark.parametrize("path", ["conv3d", "packed"])
def test_costreg_matches_jax(costreg, path):
    """Eval mode, non-trivial running statistics: the conv3d path and the
    packed path (conv_head / conv_dn / deconv_up plain versions, relu off,
    BatchNorm folded) each within atol 1e-4 of JAX's XLA path; the default
    forward without a gradient is the packed path."""
    tm, x = costreg["model"], torch.from_numpy(costreg["x"])
    launches = (pc.conv_dn.launches, pc.deconv_up.launches, pc.conv_head.launches)
    with torch.no_grad():
        got = tm.conv3d(x) if path == "conv3d" else tm.packed(x)
        if path == "packed":
            torch.testing.assert_close(tm(x), got, rtol=0, atol=0)
    assert (pc.conv_dn.launches, pc.deconv_up.launches, pc.conv_head.launches) == launches
    assert got.shape == COSTREG_SHAPE[:4] and got.dtype == torch.float32
    _compare(f"CostRegNet {path}", got, costreg["want"], 1e-4)
    assert np.abs(costreg["want"]).max() > 0.5


def test_costreg_train_mode_and_gradients(costreg):
    """train=True takes the conv3d path with batch statistics: its output
    within 1e-4 of flax's train-mode apply and the moved running statistics
    within 1e-5 (on a copy of the model); with a gradient recorded the
    default forward takes the differentiable conv3d path; a shape the
    contract refuses raises."""
    tm = load_jax_variables(CostRegNet(5, 8), costreg["v"])
    x = torch.from_numpy(costreg["x"])
    out = tm(x, train=True)
    _compare("CostRegNet train mode", out, costreg["train_out"], 1e-4)
    for i, block in enumerate([*tm.convs, *tm.deconvs]):
        name = f"ConvBlock_{i}" if i < 7 else f"DeconvBlock_{i - 7}"
        moved = costreg["moved"][name]["BatchNorm_0"]
        _compare(f"{name} running mean", block.bn.running_mean, moved["mean"], 1e-5)
        _compare(f"{name} running var", block.bn.running_var, moved["var"], 1e-5)
    y = costreg["model"](x)
    assert y.requires_grad
    y.sum().backward()
    assert costreg["model"].head.weight.grad is not None
    for shape in ((1, 4, 16, 16, 5), (1, 8, 12, 16, 5)):
        with pytest.raises(ValueError, match="divisible by 8"):
            costreg["model"](torch.zeros(shape))


def test_fpn_featurenet_matches_flax():
    """FeatureNet(arch_mode="fpn") against flax's, eval mode: the nearest ×2
    upsampling, the 1×1 laterals with bias and the 3×3 heads, 1e-4."""
    x = _rand((2, 32, 64, 3), 13)
    jm = JFeatureNet(8, 3, "fpn")
    v = _seeded(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x)), 14)
    want = [np.asarray(o) for o in jm.apply(v, jnp.asarray(x))]
    tm = load_jax_variables(FeatureNet(8, "fpn"), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert tm.out_channels == [32, 16, 8]
    for i, (g, w) in enumerate(zip(got, want)):
        _compare(f"fpn stage{i + 1}", g, w, 1e-4)


def test_window_confidence_variance_and_uncertainty_samples_match_jax():
    """window_prob_confidence (window 4 and 3), expected_variance and
    uncertainty_samples against JAX on seeded volumes, and each batched
    (B = 2) equal to its samples; 1e-6."""
    rng = np.random.default_rng(15)
    logits = rng.normal(0.0, 3.0, (2, 8, 6, 10)).astype(np.float32)
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    hyps = np.sort(rng.uniform(100, 200, (2, 8, 6, 10)), axis=1).astype(np.float32)
    tp, th = torch.from_numpy(prob), torch.from_numpy(hyps)
    depth = regression.depth_regression(tp, th)
    for window in (4, 3):
        got = regression.window_prob_confidence(tp, window)
        for b in range(2):
            want = np.asarray(jreg.window_prob_confidence(jnp.asarray(prob[b]), window))
            _compare(f"window_prob_confidence w{window}", got[b], want, 1e-6)
    var = regression.expected_variance(tp, th, depth, 1.5)
    for b in range(2):
        want = np.asarray(jreg.expected_variance(jnp.asarray(prob[b]), jnp.asarray(hyps[b]),
                                                 jnp.asarray(depth[b].numpy()), 1.5))
        _compare("expected_variance", var[b], want, 1e-6 * np.abs(want).max())
    cur, ev = depth[0], var[0]
    got = depth_range.uncertainty_samples(cur, ev, 8, torch.tensor(120.0), torch.tensor(180.0))
    want = np.asarray(jdr.uncertainty_samples(jnp.asarray(cur.numpy()), jnp.asarray(ev.numpy()),
                                              8, jnp.float32(120.0), jnp.float32(180.0)))
    _compare("uncertainty_samples", got, want, 1e-6 * 180.0)
    assert float(got.min()) >= 120.0 and float(got.max()) <= 180.0 + 1e-3


def test_window_confidence_band():
    """The band's geometry by hand (window 4: one plane before the
    truncated index, two after): mass split between planes 3 and 5 sits at
    index 4 and its band 3..6 holds all of it; split between 2 and 6 it
    holds plane 6's half only; at plane 0 the band starts in the front
    padding."""
    prob = torch.zeros((3, 8, 1, 1))
    prob[0, 3] = prob[0, 5] = 0.5
    prob[1, 2] = prob[1, 6] = 0.5
    prob[2, 0] = 1.0
    conf = regression.window_prob_confidence(prob, 4)[:, 0, 0]
    assert conf.tolist() == [1.0, 0.5, 1.0]
    prob = torch.zeros((1, 8, 1, 1))
    prob[0, 4], prob[0, 5] = 0.51, 0.49  # index 4.49 truncates to 4: planes 3..6
    assert regression.window_prob_confidence(prob, 4).item() == pytest.approx(1.0)
