"""The packed CostRegNet's whole-block kernels (`ops/kernels/conv3d_block.py`)
on the CPU, where the wrappers take their plain versions; on the card
`tests/test_torch_kernels.py -m cuda -k conv3d_block` and `chip_smoke.py`
phase 10 hold the CUDA kernels to these:

  * each block form against flax's in eval mode, the weights through the
    bridge (`params.load_jax_variables`) and the BatchNorm folded as
    `CostRegNet.packed` folds it, with perturbed statistics: ConvBlock at
    stride 1 and 2, the ReLU-less 1-channel head (`Conv3DVia2D`) and
    DeconvBlock with the skip add; 1e-5 of the largest magnitude;
  * a D-slab and an H-band, their halos joined and no zero pad on the cut
    axis, against the matching slice of the whole-volume call (1e-6 of the
    largest magnitude: the CPU's convolutions may sum a slab in another
    order; the card's kernels give the same bits);
  * the packed forward's calls (8 conv3d_block, 3 deconv3d_block), the
    wrappers' refusals, no launch counted for CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satmvs_tpu.nn import blocks as jblocks
from satmvs_tpu_torch.nn import costreg
from satmvs_tpu_torch.nn.blocks import ConvBlock, DeconvBlock
from satmvs_tpu_torch.ops.kernels import conv3d_block as cb
from satmvs_tpu_torch.params import load_jax_variables


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the module's small torch ops run beside other
    test processes, which several threads a process would oversubscribe."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _seeded(shapes, seed: int) -> dict:
    """A flax variables tree in the shapes of `shapes`: LeCun-scale kernels,
    perturbed norms and statistics (scale 1 ± 0.2, bias and mean ± 0.1, var
    in [0.5, 1.5])."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            return rng.normal(0.0, 1.0 / np.sqrt(np.prod(s.shape[:-1])), s.shape)
        if name == "scale":
            return 1.0 + 0.2 * rng.normal(size=s.shape)
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape)
        return 0.1 * rng.normal(size=s.shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(draw(p, s), np.float32), shapes)


def _compare(name, got, want, rel):
    got = got.numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = rel * np.abs(want).max()
    err = np.abs(got - want).max()
    print(f"[parity] {name}: {err:.2e} (tol {tol:.2e})")
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("kind", ["conv_s1", "conv_s2", "head", "deconv_skip"])
def test_plain_blocks_match_flax(kind):
    """The plain block forms against flax's eval-mode blocks: ConvBlock
    (stride 1, 2) as conv3d_block with the folded weights, bias and ReLU;
    the head (`Conv3DVia2D`, no bias) as conv3d_block without bias or ReLU;
    DeconvBlock + skip as deconv3d_block; 1e-5 of the largest magnitude."""
    x = _rand((1, 4, 6, 8, 5), 20)
    jx = jnp.asarray(x)
    if kind == "head":
        jm = jblocks.Conv3DVia2D(1, (3, 3, 3), padding=[(1, 1)] * 3, use_bias=False)
        tm = torch.nn.Conv3d(5, 1, 3, padding=1, bias=False)
    elif kind == "deconv_skip":
        jm, tm = jblocks.DeconvBlock(6, 3, dims=3), DeconvBlock(5, 6, dims=3)
    else:
        s = 1 if kind == "conv_s1" else 2
        jm, tm = jblocks.ConvBlock(6, 3, stride=s, dims=3), ConvBlock(5, 6, stride=s, dims=3)
    v = _seeded(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jx), 21)
    want = np.asarray(jm.apply(v, jx))
    load_jax_variables(tm, v)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        if kind == "head":
            got = cb.conv3d_block(xt, tm.weight, None, 1, relu=False)
        elif kind == "deconv_skip":
            skip = _rand(want.shape, 22)
            want = want + skip
            sc, bias = costreg._bn_fold(tm.bn)
            got = cb.deconv3d_block(xt, tm.conv.weight * sc[None, :, None, None, None], bias,
                                    torch.from_numpy(skip))
        else:
            sc, bias = costreg._bn_fold(tm.bn)
            got = cb.conv3d_block(xt, tm.conv.weight * sc[:, None, None, None, None], bias,
                                  tm.conv.stride[0], relu=True)
    assert (want < 0).any() if kind in ("head", "deconv_skip") else (want == 0).any()
    _compare(f"block {kind}", got, want, 1e-5)


def _halo(x, dim, lo, hi, before, after):
    """x[lo:hi] along dim with `before` planes before and `after` after it,
    zeros past the volume's ends (what `halo_exchange` joins on)."""
    n = x.shape[dim]
    parts = [x.narrow(dim, i, 1) if 0 <= i < n else torch.zeros_like(x.narrow(dim, 0, 1))
             for i in range(lo - before, hi + after)]
    return torch.cat(parts, dim).contiguous()


@pytest.mark.parametrize("kind", ["s1", "s2", "deconv"])
@pytest.mark.parametrize("axis", ["depth", "height"])
def test_slab_with_explicit_pads_matches_the_whole_volume(kind, axis):
    """Each half of an 8-long axis (D or H), its halo joined (zeros at the
    volume's end) and no zero pad on that axis: the matching slice of the
    whole-volume call, at both halves."""
    dim = 1 if axis == "depth" else 2
    x = torch.from_numpy(_rand((2, 8, 8, 6, 4), 23))
    bias = torch.from_numpy(_rand((5,), 24, 0.1))
    with torch.no_grad():
        if kind == "deconv":
            w = torch.from_numpy(_rand((4, 5, 3, 3, 3), 25, 0.2))
            skip = torch.from_numpy(_rand((2, 16, 16, 12, 5), 26))
            whole = cb.deconv3d_block(x, w, bias, skip)
        else:
            stride = 1 if kind == "s1" else 2
            w = torch.from_numpy(_rand((5, 4, 3, 3, 3), 25, 0.2))
            whole = cb.conv3d_block(x, w, bias, stride, relu=True)
        for lo, hi in ((0, 4), (4, 8)):
            if kind == "deconv":
                back = [1, 1, 1]
                back[dim - 1] = 0
                got = cb.deconv3d_block(_halo(x, dim, lo, hi, 0, 1), w, bias,
                                        skip.narrow(dim, 2 * lo, 2 * (hi - lo)).contiguous(),
                                        back=tuple(back))
                want = whole.narrow(dim, 2 * lo, 2 * (hi - lo))
            else:
                pads = list(cb.PAD1)
                pads[dim - 1] = (0, 0)
                got = cb.conv3d_block(_halo(x, dim, lo, hi, 1, 2 - stride), w, bias, stride,
                                      True, tuple(pads))
                want = whole.narrow(dim, lo // stride, (hi - lo) // stride)
            assert got.shape == want.shape
            torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * want.abs().max().item())


def test_packed_forward_runs_one_call_per_block(monkeypatch):
    """CostRegNet.packed: one conv3d_block per ConvBlock and the head (8),
    one deconv3d_block per DeconvBlock (3), each conv call with pad 1 on
    every axis, and the default no-grad forward is that path."""
    calls = []

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls.append((name, args, kwargs))
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(costreg, "conv3d_block", spy("conv", cb.conv3d_block))
    monkeypatch.setattr(costreg, "deconv3d_block", spy("deconv", cb.deconv3d_block))
    net = costreg.CostRegNet(5, 4).eval()
    x = torch.from_numpy(_rand((1, 8, 16, 8, 5), 27))
    with torch.no_grad():
        out = net(x)
    assert out.shape == (1, 8, 16, 8)
    assert [name for name, *_ in calls] == ["conv"] * 7 + ["deconv"] * 3 + ["conv"]
    strides = [args[3] for name, args, _ in calls if name == "conv"]
    assert strides == [1, 2, 1, 2, 1, 2, 1, 1]
    assert all(args[5] == cb.PAD1 for name, args, _ in calls if name == "conv")
    assert calls[-1][1][2] is None and calls[-1][1][4] is False  # the head: no bias, no ReLU


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """A graph, another dtype, a pad or stride the kernel lacks and a skip of
    the wrong shape raise; CPU calls count no launch."""
    before = (cb.conv3d_block.launches, cb.deconv3d_block.launches)
    x = torch.zeros((1, 4, 4, 4, 3))
    w, wt = torch.zeros((2, 3, 3, 3, 3)), torch.zeros((3, 2, 3, 3, 3))
    with pytest.raises(ValueError, match="forward-only"):
        cb.conv3d_block(x, w.requires_grad_())
    w = w.detach()
    with pytest.raises(TypeError):
        cb.conv3d_block(x.double(), w)
    with pytest.raises(ValueError):
        cb.conv3d_block(x, w, stride=3)
    with pytest.raises(ValueError):
        cb.conv3d_block(x, w, pads=((2, 0), (1, 1), (1, 1)))
    with pytest.raises(ValueError):
        cb.conv3d_block(x[..., :2], w)
    with pytest.raises(ValueError):
        cb.deconv3d_block(x, wt, torch.zeros(2), torch.zeros((1, 8, 8, 6, 2)))
    assert cb.deconv3d_block(x, wt, torch.zeros(2), torch.zeros((1, 8, 8, 8, 2))).shape == (
        1, 8, 8, 8, 2)
    assert cb.conv3d_block(x, w, stride=2).shape == (1, 2, 2, 2, 2)
    assert (cb.conv3d_block.launches, cb.deconv3d_block.launches) == before
