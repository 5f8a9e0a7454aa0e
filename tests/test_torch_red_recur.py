"""The port's ConvGRU depth recurrence (satmvs_tpu_torch/ops/kernels/red_recur.py)
against the JAX package's Pallas kernels (ops/pallas/red_recur.py: red_recur,
red_recur_from, red_recur_from_packed_batched) in interpret mode, and the port's REDRegularizer against the
JAX REDRegularizer's fused pipeline, on the CPU.  Inputs and weights come from
numpy seeds; weights are bridged by satmvs_tpu_torch/params.py.  The cell
runs at a state width of 8 and of 6 (not a multiple of 4: the widths of
`--cr_base_chs 6,6,6`, which the card's kernels run padded to 8)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from satmvs_tpu.nn.red import REDRegularizer as JRED
from satmvs_tpu.ops.pallas.red_recur import red_recur as jax_red_recur
from satmvs_tpu.ops.pallas.red_recur import _pack, _unpack, red_recur_from_packed_batched
from satmvs_tpu.ops.pallas.red_recur import red_recur_from as jax_red_recur_from
from satmvs_tpu_torch.nn.blocks import ConvGRUCell
from satmvs_tpu_torch.nn.red import REDRegularizer as TRED
from satmvs_tpu_torch.ops.kernels.red_recur import cell_kernel_args, red_recur
from satmvs_tpu_torch.params import load_jax_variables

D, H, W, CIN = 5, 8, 12, 6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the module's many small torch ops run beside
    other test processes, which several threads a process would oversubscribe."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand(shape, seed, scale=1.0, shift=0.0):
    return (shift + scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


@pytest.fixture(scope="module", params=[8, 6], ids=lambda c: f"C{c}")
def cell(request):
    """Flax-layout cell weights (HWIO kernels, GroupNorm rows r, u, y) and
    the port's ConvGRUCell loaded from them, at state width C."""
    C = request.param
    p = {"wx": _rand((3, 3, CIN, 3 * C), 0, 0.2), "wh": _rand((3, 3, C, 2 * C), 1, 0.2),
         "bh": _rand((2 * C,), 2, 0.1), "wc": _rand((3, 3, C, C), 3, 0.2),
         "bc": _rand((C,), 4, 0.1), "gn": _rand((6, C), 5, 0.3, 0.5)}
    gn = p["gn"]
    tree = {"params": {
        "Conv_x": {"kernel": p["wx"]}, "Conv_h": {"kernel": p["wh"], "bias": p["bh"]},
        "Conv_c": {"kernel": p["wc"], "bias": p["bc"]},
        "GroupNorm_0": {"scale": gn[0], "bias": gn[1]},
        "GroupNorm_1": {"scale": gn[2], "bias": gn[3]},
        "GroupNorm_2": {"scale": gn[4], "bias": gn[5]}}}
    jargs = [jnp.asarray(p[k]) for k in ("wx", "wh", "bh", "wc", "bc", "gn")]
    return jargs, load_jax_variables(ConvGRUCell(CIN, C), tree)


@pytest.fixture(scope="module")
def x():
    return _rand((D, H, W, CIN), 6)


def _compare(name, got, want, tol=1e-5):
    got = got.numpy()
    assert got.shape == want.shape
    print(f"[parity] {name}: {np.abs(got - want).max():.2e} (tol {tol})")
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_red_recur_matches_pallas(cell, x):
    """Zero start state, every plane's state: 1e-5 on states in (−1, 1)."""
    jargs, tcell = cell
    want = np.asarray(jax_red_recur(jnp.asarray(x), *jargs, interpret=True))
    with torch.no_grad():
        got = red_recur(torch.from_numpy(x), tcell)
    _compare("red_recur", got, want)


def test_red_recur_seeded_matches_pallas(cell, x):
    """Seeded start state h0 (red_recur_from): 1e-5."""
    jargs, tcell = cell
    h0 = np.tanh(_rand((H, W, tcell.features), 7))
    want = np.asarray(jax_red_recur_from(jnp.asarray(h0), jnp.asarray(x), *jargs,
                                         interpret=True))
    with torch.no_grad():
        got = red_recur(torch.from_numpy(x), tcell, torch.from_numpy(h0))
    _compare("red_recur h0", got, want)


@pytest.mark.parametrize("seeded", [False, True])
def test_batched_red_recur_matches_pallas(cell, seeded):
    """B = 2 elements, each with its own start state (zeros, or a seeded
    h0 per element), against the Pallas grid-(B, D) kernel through JAX's
    own row packing: 1e-5 on states in (−1, 1)."""
    jargs, tcell = cell
    xb = _rand((2, D, H, W, CIN), 12)
    h0 = np.tanh(_rand((2, H, W, tcell.features), 13)) if seeded else None
    xp = jnp.stack([_pack(jnp.asarray(e)) for e in xb])
    h0p = None if h0 is None else jnp.stack([_pack(jnp.asarray(e)[None])[0] for e in h0])
    outp = red_recur_from_packed_batched(h0p, xp, *jargs, H, W, interpret=True)
    want = np.stack([np.asarray(_unpack(o, H, W)) for o in outp])
    with torch.no_grad():
        got = red_recur(torch.from_numpy(xb), tcell, None if h0 is None else torch.from_numpy(h0))
    _compare(f"batched red_recur {'h0' if seeded else 'zero'}", got, want)


def test_batched_red_recur_is_per_element(cell):
    """Element b of a batched call equals the unbatched call on element b
    alone with its own h0 (exactly: the plain version is that loop)."""
    _, tcell = cell
    xb = torch.from_numpy(_rand((3, D, H, W, CIN), 14))
    h0 = torch.from_numpy(np.tanh(_rand((3, H, W, tcell.features), 15)))
    with torch.no_grad():
        got = red_recur(xb, tcell, h0)
        for b in range(3):
            torch.testing.assert_close(got[b], red_recur(xb[b], tcell, h0[b]), rtol=0, atol=0)
    with pytest.raises(ValueError):
        red_recur(xb, tcell, h0[0])


def test_red_recur_chaining(cell, x):
    """red_recur(x)[k:] == red_recur(x[k:], h0=red_recur(x[:k])[-1]): the
    state handed over between slabs is the whole state (1e-6: the same
    arithmetic, the input conv batched over other plane counts)."""
    _, tcell = cell
    xt = torch.from_numpy(x)
    with torch.no_grad():
        full = red_recur(xt, tcell)
        first = red_recur(xt[:2], tcell)
        rest = red_recur(xt[2:], tcell, first[-1])
    torch.testing.assert_close(first, full[:2], rtol=0, atol=1e-6)
    torch.testing.assert_close(rest, full[2:], rtol=0, atol=1e-6)


def test_cell_kernel_args_layout(cell):
    """The kernel's concat-conv weights hold conv_x's gate and candidate
    halves over conv_h / conv_c, tap-major, output channels fastest."""
    jargs, tcell = cell
    C = tcell.features
    wx, wh, bh, wc, bc, gn = (np.asarray(a) for a in jargs)
    wa, ba, wb, bb, g = (t.numpy() for t in cell_kernel_args(tcell))
    assert wa.shape == (9, CIN + C, 2 * C) and wb.shape == (9, CIN + C, C)
    np.testing.assert_array_equal(wa, np.concatenate([wx[..., :2 * C], wh], 2).reshape(9, -1, 2 * C))
    np.testing.assert_array_equal(wb, np.concatenate([wx[..., 2 * C:], wc], 2).reshape(9, -1, C))
    np.testing.assert_array_equal(ba, bh)
    np.testing.assert_array_equal(bb, bc)
    np.testing.assert_array_equal(g, gn)


def test_red_recur_rejects_what_the_kernel_does_not_take(cell, x):
    _, tcell = cell
    xt = torch.from_numpy(x)
    with pytest.raises(TypeError):
        red_recur(xt.double(), tcell)
    with pytest.raises(ValueError):
        red_recur(xt[..., :3], tcell)
    with pytest.raises(ValueError):
        red_recur(xt, tcell, torch.zeros((H, W, tcell.features + 1)))


def test_red_regularizer_matches_jax_fused_pipeline():
    """(1, 4, 16, 24, 8) volume → logits, against flax REDRegularizer with
    fused=True (its Pallas pipeline, interpret mode), norm parameters
    perturbed to seeded values: 1e-4 on logits of magnitude ~1."""
    from test_torch_nn import perturbed

    vol = np.abs(_rand((1, 4, 16, 24, 8), 8))
    jm = JRED(8)
    v = perturbed(jm.init(jax.random.PRNGKey(4), jnp.asarray(vol)))
    want = np.asarray(jm.apply(v, jnp.asarray(vol), True))
    tm = load_jax_variables(TRED(8, 8), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(vol))
    assert got.shape == (1, 4, 16, 24)
    _compare("REDRegularizer vs fused", got, want, 1e-4)


def test_red_pipeline_slabs_carry_the_states():
    """The pipeline over a (2, 8, 16, 24, 8) volume in slabs of 3, 3 and 2
    planes, each seeded with the states the previous slab handed on, gives
    the whole volume's logits and last-plane states (1e-5: the same
    arithmetic, convs batched over other plane counts); the states are
    contiguous (B, H/s, W/s, C_s), fine → coarse."""
    from test_torch_nn import perturbed

    vol = np.abs(_rand((2, 8, 16, 24, 8), 16))
    v = perturbed(JRED(8).init(jax.random.PRNGKey(5), jnp.asarray(vol[:1, :2])))
    tm = load_jax_variables(TRED(8, 8), v)
    vt = torch.from_numpy(vol)
    with torch.no_grad():
        full, full_states = tm.pipeline(vt)
        states, parts = None, []
        for lo, hi in ((0, 3), (3, 6), (6, 8)):
            logits, states = tm.pipeline(vt[:, lo:hi], states)
            parts.append(logits)
    assert full.shape == (2, 8, 16, 24)
    torch.testing.assert_close(torch.cat(parts, 1), full, rtol=0, atol=1e-5)
    for s, st, fst in zip((1, 2, 4, 8), states, full_states):
        assert st.shape == (2, 16 // s, 24 // s, 8 * s) and st.is_contiguous()
        torch.testing.assert_close(st, fst, rtol=0, atol=1e-5)
    torch.testing.assert_close(tm(vt), full, rtol=0, atol=0)
