"""The backward of the port's ConvGRU depth recurrence
(satmvs_tpu_torch/ops/kernels/red_recur.py: `red_recur`'s autograd Function,
whose CPU backward is `red_recur_backward_reference`) against three
references on the CPU: `jax.vjp` of the Pallas `red_recur` (interpret mode:
the dense reverse-plane adjoint `_red_recur_bwd_pallas`), the slab-streamed
adjoint `_red_recur_bwd_pallas_stream` called on the packed inputs, and
torch autograd through `red_recur_reference`; then the port's fused
`REDRegularizer` gradients against `jax.grad` of JAX's REDRegularizer on its
scan path and, marked slow (a compile of minutes), on its fused Pallas path.

Inputs and weights come from numpy seeds (kernels at flax's LeCun scale),
bridged by satmvs_tpu_torch/params.py.  The cell runs at a state width of 4
and of 6 (not a multiple of 4: the card's kernels run it padded to 8).
Cotangents are compared as a relative norm per tensor, ‖got − want‖ / ‖want‖ (the gradients sum over planes and
pixels in other orders); `-s` prints the measured values."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from satmvs_tpu.nn.red import REDRegularizer as JRED
from satmvs_tpu.ops.pallas.red_recur import (_pack, _red_recur_bwd_pallas_stream, _unpack,
                                             red_recur as jax_red_recur)
from satmvs_tpu_torch.nn.blocks import ConvGRUCell
from satmvs_tpu_torch.nn.red import REDRegularizer as TRED
from satmvs_tpu_torch.ops.kernels import red_recur as trr
from satmvs_tpu_torch.params import load_jax_variables

D, H, W, CIN = 4, 8, 16, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the module's many small torch ops run beside
    other test processes, which several threads a process would oversubscribe."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REL = 1e-4  # relative norm per cotangent, the recurrence's references
REL_RED = 1e-3  # the whole regularizer, as the JAX scan-path gradient test


def _rand(shape, seed, scale=1.0, shift=0.0):
    return (shift + scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


@pytest.fixture(scope="module", params=[4, 6], ids=lambda c: f"C{c}")
def cell(request):
    """Flax-layout cell weights (HWIO kernels at LeCun scale, GroupNorm rows
    r, u, y) and the port's ConvGRUCell loaded from them, at state width C."""
    C = request.param
    p = {"wx": _rand((3, 3, CIN, 3 * C), 0, (9 * CIN) ** -0.5),
         "wh": _rand((3, 3, C, 2 * C), 1, (9 * C) ** -0.5), "bh": _rand((2 * C,), 2, 0.1),
         "wc": _rand((3, 3, C, C), 3, (9 * C) ** -0.5), "bc": _rand((C,), 4, 0.1),
         "gn": _rand((6, C), 5, 0.3, 0.5)}
    gn = p["gn"]
    tree = {"params": {
        "Conv_x": {"kernel": p["wx"]}, "Conv_h": {"kernel": p["wh"], "bias": p["bh"]},
        "Conv_c": {"kernel": p["wc"], "bias": p["bc"]},
        "GroupNorm_0": {"scale": gn[0], "bias": gn[1]},
        "GroupNorm_1": {"scale": gn[2], "bias": gn[3]},
        "GroupNorm_2": {"scale": gn[4], "bias": gn[5]}}}
    jargs = tuple(jnp.asarray(p[k]) for k in ("wx", "wh", "bh", "wc", "bc", "gn"))
    return jargs, load_jax_variables(ConvGRUCell(CIN, C), tree)


@pytest.fixture(scope="module")
def case(cell):
    """x, g and the port's backward through the Function (dx, parameter
    cotangents), the parameter cotangents in JAX's (wx, wh, bh, wc, bc, gn)
    layout, and the forward states."""
    _, tcell = cell
    x, g = _rand((D, H, W, CIN), 6), _rand((D, H, W, tcell.features), 7)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = trr.red_recur(xt, tcell)
    grads = torch.autograd.grad(out, [xt, *tcell.parameters()], torch.from_numpy(g))
    return {"x": x, "g": g, "out": out.detach(), "dx": grads[0], "dps": grads[1:],
            "flax": _flax_grads(tcell, grads[1:])}


def _flax_grads(tcell, dps):
    """Cotangents of `cell.parameters()` → JAX's (wx, wh, bh, wc, bc, gn)."""
    d = dict(zip((n for n, _ in tcell.named_parameters()), dps))
    hwio = lambda t: t.detach().permute(2, 3, 1, 0).numpy()  # noqa: E731
    gn = torch.stack([d[f"{n}.{k}"] for n in ("gn_r", "gn_u", "gn_y") for k in ("weight", "bias")])
    return (hwio(d["conv_x.weight"]), hwio(d["conv_h.weight"]), d["conv_h.bias"].numpy(),
            hwio(d["conv_c.weight"]), d["conv_c.bias"].numpy(), gn.numpy())


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _check_all(name, dx, grads, want_dx, want_grads, tol=REL):
    names = ("dx", "dWx", "dWh", "dbh", "dWc", "dbc", "dgn")
    errs = [_rel(a, b) for a, b in zip((dx, *grads), (want_dx, *want_grads))]
    print(f"[parity] red_recur backward vs {name}: " + ", ".join(
        f"{n} {e:.2e}" for n, e in zip(names, errs)) + f" (tol {tol})")
    assert max(errs) <= tol, dict(zip(names, errs))


def test_red_recur_backward_matches_pallas_dense(cell, case):
    """`jax.vjp` of the Pallas red_recur, whose custom VJP runs the dense
    reverse-plane adjoint kernel at this size."""
    jargs, _ = cell
    _, vjp = jax.vjp(lambda x, *a: jax_red_recur(x, *a, interpret=True), jnp.asarray(case["x"]),
                     *jargs)
    jdx, *jgrads = vjp(jnp.asarray(case["g"]))
    _check_all("Pallas dense", case["dx"].numpy(), case["flax"], jdx, jgrads)


def test_red_recur_backward_matches_pallas_stream(cell, case):
    """The slab-streamed adjoint kernel on the packed x, states and g."""
    jargs, _ = cell
    pk = lambda a: _pack(jnp.asarray(a))  # noqa: E731
    dx_p, *jgrads = _red_recur_bwd_pallas_stream(pk(case["x"]), pk(case["out"].numpy()), *jargs,
                                                 pk(case["g"]), H, W, interpret=True)
    _check_all("Pallas streamed", case["dx"].numpy(), case["flax"], _unpack(dx_p, H, W), jgrads)


def test_red_recur_backward_matches_autograd_of_plain_forward(cell, case):
    """torch autograd through red_recur_reference (the plain forward)."""
    _, tcell = cell
    xt = torch.from_numpy(case["x"]).requires_grad_(True)
    want = torch.autograd.grad(trr.red_recur_reference(xt, tcell), [xt, *tcell.parameters()],
                               torch.from_numpy(case["g"]))
    _check_all("autograd", case["dx"], _flax_grads(tcell, case["dps"]), want[0],
               _flax_grads(tcell, want[1:]))


def test_batched_backward_sums_the_elements(cell):
    """B = 2 in one call: dx per element and the parameter cotangents the
    sum of the per-element calls' (1e-6 relative: the same arithmetic)."""
    _, tcell = cell
    x, g = _rand((2, 3, H, W, CIN), 8), _rand((2, 3, H, W, tcell.features), 9)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        out = trr.red_recur(xt, tcell)
    dx, dps = trr.red_recur_backward(xt, out, torch.from_numpy(g), tcell)
    per = [trr.red_recur_backward(xt[b:b + 1], out[b:b + 1], torch.from_numpy(g[b:b + 1]), tcell)
           for b in range(2)]
    for b in range(2):
        torch.testing.assert_close(dx[b], per[b][0][0], rtol=0, atol=1e-6)
    for i, p in enumerate(dps):
        assert _rel(p.numpy(), (per[0][1][i] + per[1][1][i]).numpy()) <= 1e-6


def test_seeded_start_state_with_a_gradient_raises(cell):
    """The seeded recurrence has no VJP (as in JAX): an h0 that requires a
    gradient raises where autograd records; detached, or without autograd,
    it runs, and x still gets its gradient."""
    _, tcell = cell
    xt = torch.from_numpy(_rand((3, H, W, CIN), 10)).requires_grad_(True)
    h0 = torch.from_numpy(np.tanh(_rand((H, W, tcell.features), 11))).requires_grad_(True)
    with pytest.raises(RuntimeError, match="h0"):
        trr.red_recur(xt, tcell, h0)
    out = trr.red_recur(xt, tcell, h0.detach())
    (dx,) = torch.autograd.grad(out.sum(), [xt])
    assert dx.shape == xt.shape
    with torch.no_grad():
        assert not trr.red_recur(xt, tcell, h0).requires_grad


def _regularizer_gradients(fused_jax: bool, shape, seed):
    """jax.grad of Σ sin(logits) through JAX REDRegularizer(fused=fused_jax)
    and torch autograd through the port's REDRegularizer(volume, fused=True)
    from the same seeded weights: {name: relative norm} over the volume and
    every parameter."""
    from test_torch_train import seeded

    vol = np.abs(_rand(shape, seed))
    jm = JRED(8)
    v = seeded(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(vol[:1, :1])),
               seed + 1)

    def f(params, x):
        return jnp.sum(jnp.sin(jm.apply({"params": params}, x, fused_jax)))

    jg_p, jg_v = jax.grad(f, argnums=(0, 1))(v["params"], jnp.asarray(vol))
    tm = load_jax_variables(TRED(8, 8), v)
    tv = torch.from_numpy(vol).requires_grad_(True)
    grads = torch.autograd.grad(torch.sum(torch.sin(tm(tv, fused=True))), [tv, *tm.parameters()])
    gm = load_jax_variables(TRED(8, 8), {"params": jax.tree.map(np.asarray, jg_p)})
    names = ["volume"] + [n for n, _ in tm.named_parameters()]
    wants = [np.asarray(jg_v)] + [p.detach().numpy() for p in gm.parameters()]
    errs = {n: _rel(g.numpy(), w) for n, g, w in zip(names, grads, wants)}
    worst = max(errs, key=errs.get)
    print(f"[parity] port fused REDRegularizer gradients vs jax.grad of JAX "
          f"fused={fused_jax}: max relative norm {errs[worst]:.2e} ({worst}) over "
          f"{len(errs)} tensors (tol {REL_RED})")
    return errs


def test_fused_red_regularizer_gradients_match_jax_scan():
    """The port's fused pipeline differentiated end to end at B = 2, 3
    planes, 16×32, against jax.grad of JAX's scan path (XLA), which the JAX
    package's own tests hold equal to its fused path in values and
    gradients (tests/test_plane_conv.py): the volume and every parameter to
    a relative norm of 1e-3 (no softmax follows, so the head bias has a
    gradient of its own and takes the same rule)."""
    errs = _regularizer_gradients(False, (2, 3, 16, 32, 8), 12)
    assert max(errs.values()) <= REL_RED, errs


def test_fused_red_stage_gradients_match_jax_fused():
    """One stage's regularizer at the smallest size that still chains planes
    (B = 1, 2 planes, 8×16: the scale-8 recurrence runs on 1×2 planes)
    against jax.grad of JAX REDRegularizer(fused=True), its Pallas pipeline
    and custom VJPs in interpret mode (~1 minute of compile on the CPU): the
    volume and every parameter to a relative norm of 1e-3."""
    errs = _regularizer_gradients(True, (1, 2, 8, 16, 8), 12)
    assert max(errs.values()) <= REL_RED, errs


@pytest.mark.slow
def test_fused_red_regularizer_gradients_match_jax_fused():
    """As the scan comparison above against jax.grad of JAX
    REDRegularizer(fused=True) at B = 2, 3 planes, 16×32: its Pallas
    pipeline and custom VJPs in interpret mode, whose compile takes ~3
    minutes on the CPU at this size, hence `slow`."""
    errs = _regularizer_gradients(True, (2, 3, 16, 32, 8), 12)
    assert max(errs.values()) <= REL_RED, errs
