"""The port's slab-streaming tile forward
(satmvs_tpu_torch/infer/predict.py) against the JAX package's
(satmvs_tpu/infer/predict.py) on the CPU.

Weights: a JAX CascadeREDNet variables tree filled from a numpy seed
(LeCun-scaled kernels, perturbed norm parameters and BatchNorm statistics, the
logit heads sharpened ×40 as tests/test_torch_model.py does, so the softmax
is peaked and depth parity is not trivially easy), bridged into the port by
`params.load_jax_variables`.  Depth is held to 1 % of each stage's
hypothesis step."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from satmvs_tpu.data import synthetic as jsyn
from satmvs_tpu.infer.predict import streaming_red_forward as jstream
from satmvs_tpu.models import CascadeREDNet as JNet
from satmvs_tpu_torch.data import synthetic as tsyn
from satmvs_tpu_torch.infer.predict import streaming_red_forward as tstream
from satmvs_tpu_torch.models import CascadeREDNet as TNet
from satmvs_tpu_torch.ops.kernels.red_recur import red_recur
from satmvs_tpu_torch.params import load_jax_variables


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the module's many small torch ops run beside
    other test processes, which several threads a process would oversubscribe."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


NDEPTHS = (8, 4, 4)
INTERVALS = (10.0, 5.0, 2.5)  # depth_intervals_ratio (4, 2, 1) × min_interval 2.5
SIZE = 32


def seeded_weights(seed: int = 0):
    """(flax variables of JAX CascadeREDNet(rpc, ndepths (8, 4, 4)) as numpy,
    the port's model loaded from them).  The tree's shapes come from
    `jax.eval_shape` of the JAX init (no init is run); the values from numpy:
    kernels N(0, 1/fan_in) (the scale of flax's default LeCun init), scales
    1 + 0.2·N, biases and BatchNorm means 0.1·N, variances U(0.5, 1.5); the
    RED logit heads ×40."""
    jb = jsyn.make_batch(1, SIZE, SIZE, seed=0, with_gt=False)
    jm = JNet(geo_model="rpc", ndepths=NDEPTHS)
    args = (jnp.asarray(jb["imgs"]), jb["cams"], jnp.asarray(jb["depth_values"]))
    shapes = jax.eval_shape(functools.partial(jm.init, train=False), jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def fill(tree):
        out = {}
        for k, x in tree.items():
            if isinstance(x, dict):
                out[k] = fill(x)
            elif k == "kernel":
                fan_in = int(np.prod(x.shape[:-1]))
                out[k] = rng.normal(0.0, np.sqrt(1.0 / fan_in), x.shape).astype(np.float32)
            elif k == "scale":
                out[k] = (1.0 + 0.2 * rng.normal(size=x.shape)).astype(np.float32)
            elif k in ("bias", "mean"):
                out[k] = (0.1 * rng.normal(size=x.shape)).astype(np.float32)
            elif k == "var":
                out[k] = rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
            else:
                raise KeyError(f"no seeded value for {k!r}")
        return out

    v = fill(dict(shapes))
    for i in range(3):
        head = v["params"][f"REDRegularizer_{i}"]["ScanREDStep_0"]["Conv_0"]
        head["kernel"] = head["kernel"] * 40.0
        head["bias"] = head["bias"] * 40.0
    return v, load_jax_variables(TNet(ndepths=NDEPTHS, device="cpu"), v)


@pytest.fixture(scope="module")
def weights():
    return seeded_weights()


def _steps(lo, hi):
    """Hypothesis step per stage: the range / (D − 1) at stage 1, D·interval
    / (D − 1) in the windows of stages 2-3."""
    return [(hi - lo) / (NDEPTHS[0] - 1)] + [nd * iv / (nd - 1)
                                             for nd, iv in zip(NDEPTHS[1:], INTERVALS[1:])]


def _compare_streams(want, got, dvals, what):
    for b, (lo, hi) in enumerate(dvals):
        for i, step in enumerate(_steps(lo, hi), start=1):
            w = np.asarray(want[f"stage{i}"]["depth"])[b]
            g = got[f"stage{i}"]["depth"][b].numpy()
            assert g.shape == w.shape == (SIZE // (4, 2, 1)[i - 1],) * 2
            err = np.abs(g - w).max()
            cerr = np.abs(got[f"stage{i}"]["photometric_confidence"][b].numpy()
                          - np.asarray(want[f"stage{i}"]["photometric_confidence"])[b]).max()
            print(f"[parity] {what} element {b} stage{i}: depth {err / step:.2e} of step "
                  f"(tol 0.01), confidence {cerr:.2e} (tol 2e-3)")
            assert err < 0.01 * step, f"{what} element {b} stage{i}: {err} m (step {step} m)"
            assert cerr < 2e-3, f"{what} element {b} stage{i}: confidence {cerr}"
    np.testing.assert_array_equal(got["depth"].numpy(), got["stage3"]["depth"].numpy())


@pytest.mark.parametrize("batch", [1, 2])
def test_streaming_matches_jax_fused_slabs(weights, batch):
    """slab 4 against JAX `streaming_red_forward(slab=4, fused=True)`: its
    Pallas pipeline in interpret mode, the seeded per-element recurrence at
    B = 1 and the batched grid-(B, D) recurrence at B = 2."""
    v, model = weights
    jb = jsyn.make_batch(batch, SIZE, SIZE, seed=3, with_gt=False)
    want = jstream(v, jnp.asarray(jb["imgs"]), jb["cams"], jnp.asarray(jb["depth_values"]),
                   geo_model="rpc", ndepths=NDEPTHS, slab=4, fused=True)
    tb = tsyn.make_batch(batch, SIZE, SIZE, seed=3, device="cpu")
    before = red_recur.launches
    got = tstream(model, tb["imgs"], tb["cams"], tb["depth_values"], slab=4)
    assert red_recur.launches == before  # CPU tensors: the plain versions
    _compare_streams(want, got, jb["depth_values"], f"slab 4 B={batch}")


def test_plane_streaming_matches_jax_plane_scan(weights):
    """slab 0 (one plane a step through the same pipeline) against JAX's
    plane scan (slab 0: REDStep per plane with the carried states)."""
    v, model = weights
    jb = jsyn.make_batch(1, SIZE, SIZE, seed=4, with_gt=False)
    want = jstream(v, jnp.asarray(jb["imgs"]), jb["cams"], jnp.asarray(jb["depth_values"]),
                   geo_model="rpc", ndepths=NDEPTHS, slab=0)
    tb = tsyn.make_batch(1, SIZE, SIZE, seed=4, device="cpu")
    got = tstream(model, tb["imgs"], tb["cams"], tb["depth_values"], slab=0)
    _compare_streams(want, got, jb["depth_values"], "slab 0")


def test_streaming_slabs_equal_the_full_volume(weights):
    """Within the port: slab streaming (k = 4, and k = 3, which does not
    divide 8 and falls back to one plane a step) gives the full-volume
    forward's stage-1 depth; later stages follow their own stage-1 input, so
    only stage 1 is held to the slab-independent tolerance (1e-4 of step)."""
    _, model = weights
    tb = tsyn.make_batch(2, SIZE, SIZE, seed=5, device="cpu")
    full = model(tb["imgs"], tb["cams"], tb["depth_values"])
    step = _steps(*tb["depth_values"][0].tolist())[0]
    for slab in (4, 3):
        got = tstream(model, tb["imgs"], tb["cams"], tb["depth_values"], slab=slab)
        err = (got["stage1"]["depth"] - full["stage1"]["depth"]).abs().max().item()
        print(f"[parity] slab {slab} vs full volume, stage1: {err / step:.2e} of step")
        assert err < 1e-4 * step
