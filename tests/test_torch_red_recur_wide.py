"""The ConvGRU recurrence past 1024 state channels, on the CPU: the port's
`red_recur` forward and backward at C = 1030 (the card runs it padded to
1032, past the 4·256 channels where the kernels' own-pixel passes walk more
than one group of four channels a thread) against the JAX package's
`red_recur` (the Pallas kernel in interpret mode) and its adjoint's XLA
fallback (the reverse scan of `_cell_step`'s VJP,
satmvs_tpu/ops/pallas/red_recur.py:1486-1504; at this width the dense
Pallas adjoint in interpret mode takes several times as long), the
kernels' padded arguments included (`cell_kernel_args(cell, 1032)` written
out as the kernels compute, `_param_grads` cutting their cotangents back).

Tolerances, those of the narrow widths' parity tests: states in (−1, 1)
to 1e-5 absolute (tests/test_torch_red_recur.py), the cotangents to a
relative norm of 1e-4 per tensor (tests/test_torch_red_recur_bwd.py).
Sums of 9·(Cin + C) ≈ 9.4 k products a conv output and GroupNorm moments
over 32·1030 values round in other orders in the two frameworks; on this
input the states differ by about 1e-6 and the cotangents by under 1e-6
relative (`-s` prints them)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from satmvs_tpu.ops.pallas.red_recur import _cell_step, red_recur as jax_red_recur
from satmvs_tpu_torch.nn.blocks import ConvGRUCell
from satmvs_tpu_torch.ops.kernels import red_recur as trr
from satmvs_tpu_torch.params import load_jax_variables
from test_torch_red_recur_bwd import _check_all, _flax_grads
from test_torch_red_recur_plan import _kernel_planes

D, H, W, CIN, C = 2, 4, 8, 12, 1030
ATOL = 1e-5


def _rand(shape, seed, scale=1.0, shift=0.0):
    return (shift + scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


@pytest.fixture(scope="module")
def wide():
    """Flax-layout weights at LeCun scale, the port's cell loaded from them,
    x, the output's cotangent g, JAX's forward states and its adjoint's dx
    and parameter cotangents."""
    p = (_rand((3, 3, CIN, 3 * C), 0, (9 * CIN) ** -0.5),
         _rand((3, 3, C, 2 * C), 1, (9 * C) ** -0.5), _rand((2 * C,), 2, 0.1),
         _rand((3, 3, C, C), 3, (9 * C) ** -0.5), _rand((C,), 4, 0.1), _rand((6, C), 5, 0.3, 0.5))
    wx, wh, bh, wc, bc, gn = p
    tree = {"params": {
        "Conv_x": {"kernel": wx}, "Conv_h": {"kernel": wh, "bias": bh},
        "Conv_c": {"kernel": wc, "bias": bc},
        "GroupNorm_0": {"scale": gn[0], "bias": gn[1]},
        "GroupNorm_1": {"scale": gn[2], "bias": gn[3]},
        "GroupNorm_2": {"scale": gn[4], "bias": gn[5]}}}
    jargs = tuple(jnp.asarray(a) for a in p)
    x, g = _rand((D, H, W, CIN), 6), _rand((D, H, W, C), 7)
    out = np.asarray(jax_red_recur(jnp.asarray(x), *jargs, interpret=True))
    jdx, jgrads = _jax_adjoint(jargs, x, jnp.asarray(out), g)
    return {"cell": load_jax_variables(ConvGRUCell(CIN, C), tree), "x": x, "g": g, "out": out,
            "jdx": jdx, "jgrads": jgrads}


def _jax_adjoint(jargs, x, out, g):
    """JAX's adjoint fallback: a reverse scan of `_cell_step`'s VJP from the
    forward's states (zeros before plane 0): dx and (dwx, dwh, dbh, dwc,
    dbc, dgn)."""
    h_prev = jnp.concatenate([jnp.zeros_like(out[:1]), out[:-1]], axis=0)

    def step(carry, inp):
        dh, dps = carry
        hp, x_d, g_d = inp
        _, vjp = jax.vjp(_cell_step, hp, x_d, *jargs)
        dhp, dx_d, *dp = vjp(dh + g_d)
        return (dhp, jax.tree.map(jnp.add, dps, tuple(dp))), dx_d

    zero = (jnp.zeros_like(out[0]), jax.tree.map(jnp.zeros_like, jargs))
    (_, dps), dx = jax.lax.scan(step, zero, (h_prev, jnp.asarray(x), jnp.asarray(g)),
                                reverse=True)
    return np.asarray(dx), [np.asarray(t) for t in dps]


def test_wide_red_recur_matches_pallas(wide):
    """The port's forward at C = 1030 against the Pallas kernel: 1e-5."""
    with torch.no_grad():
        got = trr.red_recur(torch.from_numpy(wide["x"]), wide["cell"]).numpy()
    err = np.abs(got - wide["out"]).max()
    print(f"[parity] red_recur C={C}: {err:.2e} (tol {ATOL})")
    assert got.shape == wide["out"].shape and err <= ATOL


def test_wide_padded_arguments_compute_the_cell(wide):
    """The kernels' arguments at the padded width 1032, written out as the
    kernels compute (statistics over the 1030 real channels): JAX's states
    to 1e-5 and pad channels exactly 0; their cotangents, cut back by
    `_param_grads`, JAX's adjoint's to 1e-4 relative."""
    cell, c4 = wide["cell"], trr.padded_width(C)
    assert c4 == 1032 > 4 * trr.RED_BWD_THREADS
    args = [t.clone().requires_grad_(True) for t in trr.cell_kernel_args(cell, c4)]
    got = _kernel_planes(torch.from_numpy(wide["x"]), *args, C)
    err = np.abs(got[..., :C].detach().numpy() - wide["out"]).max()
    print(f"[parity] padded red_recur C={C} at {c4}: {err:.2e} (tol {ATOL})")
    assert err <= ATOL and (got[..., C:] == 0).all()
    dwa, dba, dwb, dbb, dgn = torch.autograd.grad(
        (got[..., :C] * torch.from_numpy(wide["g"])).sum(), args)
    dps = trr._param_grads(cell, dwa.reshape(3, 3, *dwa.shape[1:]), dba,
                           dwb.reshape(3, 3, *dwb.shape[1:]), dbb, dgn)
    names = ("dWx", "dWh", "dbh", "dWc", "dbc", "dgn")
    for name, a, b in zip(names, _flax_grads(cell, dps), wide["jgrads"]):
        rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        print(f"[parity] padded red_recur C={C} {name}: {rel:.2e} (tol 1e-4)")
        assert rel <= 1e-4, name


def test_wide_red_recur_backward_matches_jax(wide):
    """The port's backward through its autograd Function at C = 1030 (on
    the CPU the plain reverse-plane backward) against JAX's adjoint: dx and
    every parameter's cotangent to 1e-4 relative."""
    cell = wide["cell"]
    xt = torch.from_numpy(wide["x"]).requires_grad_(True)
    out = trr.red_recur(xt, cell)
    grads = torch.autograd.grad(out, [xt, *cell.parameters()], torch.from_numpy(wide["g"]))
    _check_all(f"JAX's adjoint fallback at C={C}", grads[0].numpy(),
               _flax_grads(cell, grads[1:]), wide["jdx"], wide["jgrads"])
