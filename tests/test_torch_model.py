"""The whole slice: the port's CascadeREDNet (RPC, inference, the fused RED
pipeline of plain versions on the CPU) against
`satmvs_tpu.models.CascadeREDNet(geo_model="rpc", fused_red=False)` on the
same synthetic batch and bridged weights, on the CPU (the JAX fused and scan
paths compute the same function).

The logit heads are sharpened ×40 in both (as tests/test_full_net_parity.py
does) so the softmax is peaked and depth parity is not trivially easy;
norm parameters and BatchNorm statistics are perturbed to seeded values."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from satmvs_tpu.data import synthetic as jsyn
from satmvs_tpu.models import CascadeREDNet as JNet
from satmvs_tpu_torch.data import synthetic as tsyn
from satmvs_tpu_torch.models import CascadeREDNet as TNet
from satmvs_tpu_torch.ops.kernels.plane_conv import conv_dn, conv_head, deconv_up
from satmvs_tpu_torch.ops.kernels.red_recur import red_recur
from satmvs_tpu_torch.ops.kernels.sweep_variance import sweep_variance
from satmvs_tpu_torch.params import load_jax_variables

H, W = 32, 64


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


def _perturbed(variables, seed=0):
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


@pytest.fixture(scope="module")
def both_runs():
    jb = jsyn.make_batch(1, W, H, seed=0, with_gt=False)
    jm = JNet(geo_model="rpc", ndepths=NDEPTHS, fused_red=False)
    args = (jnp.asarray(jb["imgs"]), jb["cams"], jnp.asarray(jb["depth_values"]))
    v = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0), *args))
    for i in range(3):
        head = v["params"][f"REDRegularizer_{i}"]["ScanREDStep_0"]["Conv_0"]
        head["kernel"] = head["kernel"] * 40.0
        head["bias"] = head["bias"] * 40.0
    want = jax.tree.map(np.asarray, jax.jit(jm.apply)(v, *args))

    tb = tsyn.make_batch(1, W, H, seed=0, device="cpu")
    tm = load_jax_variables(TNet(ndepths=NDEPTHS, device="cpu"), v)
    wrappers = (sweep_variance, conv_dn, red_recur, deconv_up, conv_head)
    launches = [fn.launches for fn in wrappers]
    got = tm(tb["imgs"], tb["cams"], tb["depth_values"])
    assert [fn.launches for fn in wrappers] == launches  # CPU tensors: the plain versions
    return want, got, jb["depth_values"][0]


def test_slice_depth_matches_jax(both_runs):
    """Per-stage depth within 1 % of the stage's hypothesis step: the full
    height range / (D − 1) at stage 1 (128.6 m), D·interval / (D − 1) in the
    windows of stages 2-3 (6.7 m, 3.3 m)."""
    want, got, dv = both_runs
    steps = [(dv[1] - dv[0]) / (NDEPTHS[0] - 1)]
    steps += [nd * iv / (nd - 1) for nd, iv in zip(NDEPTHS[1:], INTERVALS[1:])]
    for i, step in enumerate(steps, start=1):
        w = want[f"stage{i}"]["depth"]
        g = got[f"stage{i}"]["depth"].numpy()
        scale = (4, 2, 1)[i - 1]
        assert g.shape == w.shape == (1, H // scale, W // scale)
        err = np.abs(g - w).max()
        print(f"[parity] slice stage{i} depth: {err:.2e} m = {err / step:.2e} of step (tol 0.01)")
        assert err < 0.01 * step, f"stage{i}: {err} m (step {step} m)"
    np.testing.assert_array_equal(got["depth"].numpy(), got["stage3"]["depth"].numpy())


def test_slice_confidence_matches_jax(both_runs):
    """Max-prob confidence within 2e-3 (probabilities in [0, 1]); the
    sharpened heads make it span most of that range."""
    want, got, _ = both_runs
    for i in (1, 2, 3):
        w = want[f"stage{i}"]["photometric_confidence"]
        g = got[f"stage{i}"]["photometric_confidence"].numpy()
        print(f"[parity] slice stage{i} confidence: {np.abs(g - w).max():.2e} (tol 2e-3)")
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-3, err_msg=f"stage{i}")
    assert want["stage3"]["photometric_confidence"].max() > 0.9
    np.testing.assert_array_equal(got["photometric_confidence"].numpy(),
                                  got["stage3"]["photometric_confidence"].numpy())
