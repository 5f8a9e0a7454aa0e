"""The backwards of the port's plane convolutions
(satmvs_tpu_torch/ops/kernels/plane_conv.py: conv_dn, deconv_up, conv_head,
each a torch.autograd.Function whose CPU backward is the plain backward)
against `jax.vjp` of the JAX package's Pallas kernels (ops/pallas/plane_conv.py)
in interpret mode, so `_conv_dn_bwd`, `_deconv_up_bwd` and `_conv_head_bwd`
run, and against torch autograd through the plain forwards, on the CPU.

Weights are drawn in flax layout with numpy at flax's LeCun scale and bridged
by the rule of satmvs_tpu_torch/params.py: a flax Conv kernel (kh, kw, I, O)
and a flax ConvTranspose kernel (kh, kw, O, I) both become torch weights by the
axis order (3, 2, 0, 1), and their cotangents come back the same way.
Tolerance: 1e-5 × max(1, max |want|) per cotangent (fp32 sums in another
order); `-s` prints the measured maxima."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from satmvs_tpu.ops.pallas import plane_conv as pc
from satmvs_tpu_torch.ops.kernels import plane_conv as tpc


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the module's many small torch ops run beside
    other test processes, which several threads a process would oversubscribe."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


D = 2


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _lecun(shape, seed, fan_in):
    return _rand(shape, seed, (1.0 / fan_in) ** 0.5)


def _torch_weight(k):
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


def _flax_weight(t):
    return t.detach().numpy().transpose(2, 3, 1, 0)


def _compare(name, got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    print(f"[parity] {name}: {err:.2e} (tol {tol:.2e})")
    assert got.shape == want.shape, (got.shape, want.shape)
    assert err <= tol, (name, err, tol)


def _torch_grads(fn, inputs, g):
    """torch.autograd.grad of fn(*inputs) against the cotangent g."""
    ts = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    out = fn(*ts)
    return out, torch.autograd.grad(out, ts, torch.from_numpy(g))


@pytest.mark.parametrize("h,w,cin,cout", [(8, 16, 8, 16), (16, 8, 4, 8)])
def test_conv_dn_backward_matches_pallas(h, w, cin, cout):
    """dx and dweight of the stride-2 conv + ReLU against `jax.vjp` of the
    Pallas conv_dn; the Function's backward equals autograd through the
    plain forward."""
    x, k = _rand((D, h, w, cin), 0), _lecun((3, 3, cin, cout), 1, 9 * cin)
    g = _rand((D, h // 2, w // 2, cout), 2)

    def jfn(x, k):
        xe, xo = pc.split_cols(pc.pack_planes(x))
        return pc.unpack_planes(pc.conv_dn(xe, xo, k, h, w), h // 2, w // 2)

    _, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(k))
    jdx, jdk = vjp(jnp.asarray(g))
    wt = _torch_weight(k).numpy()
    _, (dx, dw) = _torch_grads(tpc.conv_dn, (x, wt), g)
    _compare(f"conv_dn {h}x{w} dx", dx, jdx)
    _compare(f"conv_dn {h}x{w} dweight", _flax_weight(dw), jdk)
    _, (rdx, rdw) = _torch_grads(tpc.conv_dn_reference, (x, wt), g)
    torch.testing.assert_close(dx, rdx, rtol=0, atol=1e-5)
    torch.testing.assert_close(dw, rdw, rtol=0, atol=1e-5)


@pytest.mark.parametrize("h,w,cin,cout", [(4, 8, 16, 8), (8, 4, 8, 4)])
def test_deconv_up_backward_matches_pallas(h, w, cin, cout):
    """dx, dweight and the skip's cotangent of the stride-2 transposed conv
    + ReLU, with and without the skip after the ReLU, against `jax.vjp` of
    the Pallas deconv_up with the skip added in XLA, as JAX's pipeline adds
    it (the add leaves dx and dweight as they are); the Function's backward
    equals autograd through the plain forward."""
    x, kt = _rand((D, h, w, cin), 3), _lecun((3, 3, cout, cin), 4, 9 * cin)
    skip = _rand((D, 2 * h, 2 * w, cout), 5)
    g = _rand((D, 2 * h, 2 * w, cout), 6)

    def jfn(x, kt, skip):
        ye, yo = pc.deconv_up(pc.pack_planes(x), kt, h, w)
        return pc.unpack_planes(pc.merge_cols(ye, yo), 2 * h, 2 * w) + skip

    _, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (x, kt, skip)))
    jdx, jdk, jds = vjp(jnp.asarray(g))
    wt = _torch_weight(kt).numpy()
    for inputs in ((x, wt), (x, wt, skip)):
        _, grads = _torch_grads(tpc.deconv_up, inputs, g)
        tag = f"deconv_up {h}x{w}{' + skip' if len(inputs) == 3 else ''}"
        _compare(f"{tag} dx", grads[0], jdx)
        _compare(f"{tag} dweight", _flax_weight(grads[1]), jdk)
        if len(inputs) == 3:
            _compare(f"{tag} dskip", grads[2], jds)
        _, ref = _torch_grads(tpc.deconv_up_reference, inputs, g)
        for a, b in zip(grads, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_deconv_up_backward_reads_the_mask_from_relu_z():
    """Pre-activations of ±1e-7 under a skip of 4: relu(z) + skip rounds
    every such z away (out − skip > 0 misreads the mask), yet dx and dweight
    match `jax.vjp` of the Pallas kernel, whose backward reads relu(z)."""
    h, w, cin, cout = 4, 8, 8, 8
    x, kt = _rand((D, h, w, cin), 7), _rand((3, 3, cout, cin), 8, 3e-8)
    skip = np.full((D, 2 * h, 2 * w, cout), 4.0, np.float32)
    g = _rand((D, 2 * h, 2 * w, cout), 9)

    def jfn(x, kt, skip):
        ye, yo = pc.deconv_up(pc.pack_planes(x), kt, h, w)
        return pc.unpack_planes(pc.merge_cols(ye, yo), 2 * h, 2 * w) + skip

    _, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (x, kt, skip)))
    jdx, jdk, _ = vjp(jnp.asarray(g))
    out, (dx, dw, _) = _torch_grads(tpc.deconv_up, (x, _torch_weight(kt).numpy(), skip), g)
    act = tpc.deconv_up_reference(torch.from_numpy(x), _torch_weight(kt))
    misread = ((out.detach() - torch.from_numpy(skip) > 0) != (act > 0)).float().mean().item()
    print(f"[parity] deconv_up tiny z: share of the mask that out - skip misreads {misread:.3f}")
    assert misread > 0.25
    _compare("deconv_up tiny z dx", dx, jdx)
    _compare("deconv_up tiny z dweight", _flax_weight(dw), jdk)


@pytest.mark.parametrize("h,w,cin", [(8, 16, 8), (6, 4, 4)])
def test_conv_head_backward_matches_pallas(h, w, cin):
    """dx, dweight and dbias of the stride-1 conv + bias against `jax.vjp`
    of the Pallas conv_head; the Function's backward equals autograd through
    the plain forward."""
    x, k, b = _rand((D, h, w, cin), 10), _lecun((3, 3, cin, 1), 11, 9 * cin), _rand((1,), 12)
    g = _rand((D, h, w, 1), 13)

    def jfn(x, k, b):
        return pc.unpack_planes(pc.conv_head(pc.pack_planes(x), k, b, h, w), h, w)

    _, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (x, k, b)))
    jdx, jdk, jdb = vjp(jnp.asarray(g))
    inputs = (x, _torch_weight(k).numpy(), b)
    _, (dx, dw, db) = _torch_grads(tpc.conv_head, inputs, g)
    _compare(f"conv_head {h}x{w} dx", dx, jdx)
    _compare(f"conv_head {h}x{w} dweight", _flax_weight(dw), jdk)
    _compare(f"conv_head {h}x{w} dbias", db, jdb)
    _, ref = _torch_grads(tpc.conv_head_reference, inputs, g)
    for a, b_ in zip((dx, dw, db), ref):
        torch.testing.assert_close(a, b_, rtol=0, atol=1e-5)


def test_backward_wrappers_count_only_on_the_card():
    """On the CPU the backward wrappers return the plain backwards exactly
    and count no launch; conv_dn refuses a graph at odd sizes, whose
    transposed conv would need another output padding."""
    x = torch.from_numpy(_rand((2, 6, 10, 4), 14)).requires_grad_(True)
    wd = torch.from_numpy(_rand((8, 4, 3, 3), 15))
    y = tpc.conv_dn(x, wd)
    g = torch.from_numpy(_rand(tuple(y.shape), 16))
    counts = (tpc.conv_dn_backward.launches, tpc.deconv_up_backward.launches,
              tpc.conv_head_backward.launches)
    for a, b in zip(tpc.conv_dn_backward(x.detach(), wd, y.detach(), g),
                    tpc.conv_dn_backward_reference(x.detach(), wd, y.detach(), g)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.autograd.grad(y, x, g)
    assert counts == (tpc.conv_dn_backward.launches, tpc.deconv_up_backward.launches,
                      tpc.conv_head_backward.launches) == (0, 0, 0)
    with pytest.raises(ValueError, match="even"):
        tpc.conv_dn(x[:, :5], wd)
    with torch.no_grad():
        assert tpc.conv_dn(x[:, :5], wd).shape == (2, 3, 5, 8)
