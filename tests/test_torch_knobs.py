"""The model's knobs on the CPU against the JAX package: the bf16
compute_dtype (FeatureNet and the CostRegNet in eval and train mode, the
RED scan forward and, `slow`, a whole train step against JAX with
`compute_dtype=jnp.bfloat16`), remat (bit for bit the step without it on the port's three
paths: RED fused, RED scan, CasMVS, running statistics included; against
JAX's remat step, `slow`) and torch_compat (the reference's hypothesis
chain, the full-volume and streaming forwards and, `slow`, a train step
against JAX's `torch_compat=True`).

Weights come from numpy seeds at flax's LeCun scale
(`test_torch_train.seeded`) through `params.load_jax_variables`.  bf16 is
compared op for op: JAX compiles without XLA's excess precision (`_strict`),
so it rounds where flax's promote_dtype says, as torch does; where train-
mode BatchNorm makes a bf16 network chaotic, the gate is a multiple of the
distance a sub-ulp nudge of the input moves the port's own run
(BF16_SPREAD)."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from satmvs_tpu.data import synthetic as jsyn
from satmvs_tpu.models import build_model as jbuild
from satmvs_tpu.models.cascade import stage_hypotheses as jstage_hypotheses
from satmvs_tpu.nn.costreg import CostRegNet as JCostReg
from satmvs_tpu.nn.featurenet import FeatureNet as JFeatureNet
from satmvs_tpu.ops import depth_range as jdr
from satmvs_tpu.train.config import Config as JConfig
from satmvs_tpu.train.loop import TrainState as JState
from satmvs_tpu.train.loop import make_optimizer as jmake_optimizer
from satmvs_tpu.train.loop import make_train_step as jmake_train_step
from satmvs_tpu.train.loop import numeric_batch
from satmvs_tpu_torch.data import synthetic as tsyn
from satmvs_tpu_torch.infer.predict import streaming_red_forward
from satmvs_tpu_torch.models import CascadeMVSNet, CascadeREDNet
from satmvs_tpu_torch.models.cascade import stage_hypotheses
from satmvs_tpu_torch.nn.costreg import CostRegNet
from satmvs_tpu_torch.nn.featurenet import FeatureNet
from satmvs_tpu_torch.params import load_jax_variables
from satmvs_tpu_torch.train import Config, create_model, create_model_and_state, make_train_step

from test_torch_train import H, NDEPTHS, W, seeded

BF16 = torch.bfloat16
# a bf16 train-mode comparison against JAX: at most this multiple of the
# distance a sub-ulp nudge of the input moves the port's own bf16 run
BF16_SPREAD = 1.5
DEPTH_MEAN, DEPTH_P99 = 0.01, 0.1   # of a hypothesis step (tests/test_torch_model.py)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the module's many small torch ops run beside
    other test processes, which several threads a process would oversubscribe."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jbatch():
    jb = numeric_batch(jsyn.make_batch(1, W, H, seed=0))
    return jb, (jb["imgs"], jb["cams"], jb["depth_values"])


def _variables(jm, args, seed):
    return seeded(jax.eval_shape(functools.partial(jm.init, train=False),
                                 jax.random.PRNGKey(0), *args), seed)


def _steps(dvals) -> list:
    """Hypothesis step per stage at ndepths (8, 4, 4), intervals 10, 5, 2.5."""
    lo, hi = (float(x) for x in dvals)
    return [(hi - lo) / (NDEPTHS[0] - 1)] + [nd * iv / (nd - 1)
                                             for nd, iv in zip(NDEPTHS[1:], (5.0, 2.5))]


def _depth_err(got: dict, want: dict, dvals, i: int) -> np.ndarray:
    g = got[f"stage{i}"]["depth"]
    g = g.detach().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
    return np.abs(g - np.asarray(want[f"stage{i}"]["depth"])) / _steps(dvals)[i - 1]


def _rel(a: torch.Tensor, b) -> float:
    b = torch.as_tensor(np.array(b, np.float32))
    return ((a.detach().float() - b).norm() / b.norm()).item()


def _nudged(x: np.ndarray, seed: int = 9) -> np.ndarray:
    """x moved by a relative 1e-4: far below a bf16 ulp (2⁻⁸ ≈ 3.9e-3),
    enough to flip the rounding of a few of the values a bf16 network
    rounds."""
    return (x * (1.0 + 1e-4 * np.random.default_rng(seed).normal(size=x.shape))).astype(x.dtype)


def _strict(jitted, *args):
    """A jitted JAX function compiled without XLA's excess precision
    (`xla_allow_excess_precision`, on by default: under jit XLA may skip
    the bf16 roundings a program declares), then run: every bf16 op of
    flax's promote_dtype rounds, as it does op by op and as torch does."""
    return jitted.lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


# ---- bf16 compute_dtype ------------------------------------------------

def test_bf16_featurenet_matches_jax():
    """FeatureNet(dtype=bf16) against flax's FeatureNet(dtype=jnp.bfloat16),
    both decoders.  Eval mode: 5e-3 relative norm (0 measured with the unet
    decoder, 2.6e-3 with fpn): torch's CPU bf16 convolution rounds a few
    outputs (6e-5 of them, measured) one ulp (2⁻⁸ relative) away from
    fp32-then-round, where XLA's does not, and a flip carries on through
    the later layers.  Train mode (batch statistics, running statistics moved):
    a bf16 network in train mode moves by ~1e-2 when its input moves by a
    relative 1e-4, far below a bf16 ulp (`_nudged`, measured on the port's
    own run); the port stays within BF16_SPREAD of that and 2e-2 relative
    norm, the running statistics within 1e-2 of each tensor's largest
    value (2.8e-4 measured)."""
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(np.float32)
    for mode in ("unet", "fpn"):
        jm = JFeatureNet(8, 3, mode, dtype=jnp.bfloat16)
        v = seeded(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x)), 2)
        m = load_jax_variables(FeatureNet(8, mode, BF16), v)
        jx = jnp.asarray(x)
        evals = _strict(jax.jit(lambda v, x: jm.apply(v, x)), v, jx)
        for k, (g, w) in enumerate(zip(m(torch.from_numpy(x)), evals)):
            assert g.dtype == torch.float32 and _rel(g, w) <= 5e-3, (mode, k)
        want, upd = _strict(jax.jit(lambda v, x: jm.apply(v, x, True, mutable=["batch_stats"])),
                            v, jx)
        got = m(torch.from_numpy(x), True)
        nudged = load_jax_variables(FeatureNet(8, mode, BF16), v)(
            torch.from_numpy(_nudged(x)), True)
        for k, w in enumerate(want):
            err, spread = _rel(got[k], w), _rel(nudged[k], got[k].detach())
            print(f"[parity] bf16 FeatureNet {mode} train out{k}: {err:.2e} relative norm, the "
                  f"nudged run {spread:.2e} (tol 2e-2, {BF16_SPREAD}× the nudged run)")
            assert err <= 2e-2 and err <= BF16_SPREAD * spread
        new = jax.tree.map(np.asarray, upd["batch_stats"])
        ref = load_jax_variables(FeatureNet(8, mode), {"params": v["params"], "batch_stats": new})
        stats = {n: b for n, b in ref.named_buffers() if "running" in n}
        worst = max(((b - stats[n]).abs().max() / stats[n].abs().max()).item()
                    for n, b in m.named_buffers() if "running" in n)
        print(f"[parity] bf16 FeatureNet {mode} running statistics: {worst:.2e} (tol 1e-2)")
        assert worst <= 1e-2


def test_bf16_costregnet_matches_jax():
    """CostRegNet(dtype=bf16) takes its conv3d path (cuDNN's on the card),
    eval and train mode, against flax's CostRegNet(dtype=jnp.bfloat16).
    JAX's `Conv3DVia2D` rounds each depth tap's 2-D conv to bf16 and sums
    the three in bf16, where one conv3d rounds once: two more bf16
    roundings an output, 2.2e-3 (eval) and 8.7e-3 (train) relative norm
    measured, under 5e-3 and 2e-2; the port's bf16 logits differ from its
    fp32 ones (bf16 engaged), and bf16 inference never takes the packed
    float32 path."""
    vol = np.random.default_rng(1).normal(size=(1, 8, 16, 16, 8)).astype(np.float32)
    jm = JCostReg(8, dtype=jnp.bfloat16, fused=False)
    v = seeded(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(vol)), 4)
    for train, tol in ((False, 5e-3), (True, 2e-2)):
        want = _strict(jax.jit(lambda v, x: jm.apply(v, x, train, mutable=["batch_stats"])[0]),
                       v, jnp.asarray(vol))
        got, fp32 = (load_jax_variables(CostRegNet(8, 8, fused=False, dtype=dt), v)(
            torch.from_numpy(vol), train) for dt in (BF16, None))
        err = _rel(got, want)
        print(f"[parity] bf16 CostRegNet train={train}: {err:.2e} relative norm (tol {tol}); "
              f"the fp32 run {_rel(fp32, want):.2e}")
        assert got.dtype == torch.float32 and err <= tol and not torch.equal(got, fp32)
    packed = load_jax_variables(CostRegNet(8, 8, dtype=BF16), v)
    calls = []
    packed.packed = lambda *a: calls.append(a)
    packed(torch.from_numpy(vol))
    assert not calls


@pytest.fixture(scope="module")
def bf16_forward():
    """JAX CascadeREDNet(compute_dtype=bf16) at inference (its RED scan path
    on the CPU, compiled by `_strict`) and the port's bf16 forwards on the
    scan path (also on `_nudged` images) and on the fused pipeline."""
    jb, args = _jbatch()
    jm = jbuild("red", "rpc", ndepths=NDEPTHS, fused_red=False, compute_dtype=jnp.bfloat16)
    v = _variables(jm, args, 6)
    want = jax.tree.map(np.asarray, _strict(
        jax.jit(lambda v, *a: jm.apply(v, *a, train=False)), v, *args))
    tb = tsyn.make_batch(1, W, H, seed=0, device="cpu")
    got = {}
    for name, fr, imgs in (("scan", False, tb["imgs"]),
                           ("nudged", False, torch.from_numpy(_nudged(tb["imgs"].numpy()))),
                           ("fused", None, tb["imgs"])):
        m = load_jax_variables(CascadeREDNet(ndepths=NDEPTHS, fused_red=fr, compute_dtype=BF16,
                                             device="cpu"), v)
        got[name] = m(imgs, tb["cams"], tb["depth_values"])
    return {"want": want, "got": got, "dv": jb["depth_values"][0]}


def test_bf16_forward_matches_jax(bf16_forward):
    """The bf16 forward on the RED scan path (FeatureNet, the encoder,
    decoder and head in bf16, the cells float32 on the encoder's bf16
    values): per-stage depth against JAX's, its mean and p99 within
    BF16_SPREAD of the distance `_nudged` images move the port's own bf16
    forward (mean 1.4e-3, 1.8e-2 and 3.4e-2 of a step at stages 1-3,
    measured: bf16 rounding, not the port, sets the distance, past the 1 %
    fp32 gate at stages 2-3)."""
    r = bf16_forward
    for i in (1, 2, 3):
        err = _depth_err(r["got"]["scan"], r["want"], r["dv"], i)
        own = {k: {"depth": v["depth"].numpy()} for k, v in r["got"]["scan"].items()
               if k.startswith("stage")}
        spread = _depth_err(r["got"]["nudged"], own, r["dv"], i)
        p99, s99 = np.quantile(err, 0.99), np.quantile(spread, 0.99)
        print(f"[parity] bf16 forward stage{i}: depth err mean {err.mean():.2e}, p99 "
              f"{p99:.2e} of step; the nudged forward's {spread.mean():.2e}, {s99:.2e} (tol "
              f"{BF16_SPREAD}× those)")
        assert err.mean() <= BF16_SPREAD * spread.mean() and p99 <= BF16_SPREAD * s99


def test_bf16_fused_forward_keeps_red_fp32(bf16_forward):
    """With the fused RED pipeline (the default) bf16 reaches FeatureNet
    only, as JAX's Pallas path: the pipeline and its kernels stay float32
    and every parameter stays float32."""
    r = bf16_forward
    for i in (1, 2, 3):
        d = r["got"]["fused"][f"stage{i}"]["depth"]
        assert d.dtype == torch.float32 and bool(torch.isfinite(d).all())
    model = CascadeREDNet(ndepths=NDEPTHS, compute_dtype=BF16, device="cpu")
    assert model.feature.dtype == BF16 and all(reg.step.dtype == BF16 for reg in model.regs)
    assert all(p.dtype == torch.float32 for p in model.parameters())


def _jax_step(jm, v, jb, strict: bool = False, dlossw=(0.5, 1.0, 2.0)):
    jcfg = JConfig(ndepths=NDEPTHS, fused_red=False)
    jtx = jmake_optimizer(jcfg, 2)
    jstate = JState(params=v["params"], batch_stats=v["batch_stats"],
                    opt_state=jtx.init(v["params"]), step=jnp.zeros((), jnp.int32))
    step = jmake_train_step(jm, jtx, dlossw)
    new, scalars = _strict(step, jstate, jb) if strict else step(jstate, jb)
    return ({"params": jax.tree.map(np.asarray, new.params),
             "batch_stats": jax.tree.map(np.asarray, new.batch_stats)},
            {k: float(x) for k, x in scalars.items()})


def _port_step(variables, remat: bool = False, nudge: bool = False, **fields):
    tb = tsyn.make_batch(1, W, H, seed=0, device="cpu")
    if nudge:
        tb["imgs"] = torch.from_numpy(_nudged(tb["imgs"].numpy()))
    cfg = Config(ndepths=NDEPTHS, **fields)
    model, state, tx = create_model_and_state(cfg, tb, 2, variables=variables)
    model.remat = remat
    old = {k: v.detach().clone() for k, v in state.params.items()}
    state, scalars = make_train_step(model, tx, cfg.dlossw)(state, tb)
    return {"old": old, "params": {k: v.detach() for k, v in state.params.items()},
            "stats": dict(state.batch_stats), "scalars": {k: float(x) for k, x in scalars.items()}}


def _update_err(got: dict, new) -> tuple[float, float]:
    """(relative norm of the update difference over all parameters, worst
    running-statistic difference / the tensor's largest value) against
    another step's new state: a JAX variables tree or a `_port_step`; the
    logit heads' biases, pure rounding, left out."""
    if "old" in new:
        want, bufs = new["params"], new["stats"]
    else:
        m = load_jax_variables(CascadeREDNet(ndepths=NDEPTHS, device="cpu"), new)
        want, bufs = dict(m.named_parameters()), dict(m.named_buffers())
    num = den = 0.0
    for n, p in got["params"].items():
        if n.endswith("head.bias"):
            continue
        d_got, d_want = p - got["old"][n], want[n] - got["old"][n]
        num += (d_got - d_want).norm().item() ** 2
        den += d_want.norm().item() ** 2
    stats = max(((b - bufs[n]).abs().max() / bufs[n].abs().max()).item()
                for n, b in got["stats"].items())
    return (num / den) ** 0.5, stats


@pytest.mark.slow
def test_bf16_step_matches_jax():
    """One train step with compute_dtype bf16 (the RED scan path, as JAX's
    on the CPU) against JAX's `make_train_step` with compute_dtype=
    jnp.bfloat16 (compiled by `_strict`): loss, update over all parameters
    and running statistics within BF16_SPREAD of the port's own bf16 step
    under `_nudged` images (train-mode BatchNorm over bf16 convolutions
    moves the step by that much: 1.3e-3 of the loss, 0.46 of the update,
    3.3e-4 of the statistics, measured).  `slow`: JAX's step compiles in
    ~30 s; the train-mode FeatureNet and CostRegNet tests are its fast
    counterparts."""
    jb, args = _jbatch()
    jm = jbuild("red", "rpc", ndepths=NDEPTHS, fused_red=False, compute_dtype=jnp.bfloat16)
    v = _variables(jm, args, 6)
    jnew, jscal = _jax_step(jm, v, jb, strict=True)
    got = _port_step(v, fused_red=False, compute_dtype="bfloat16")
    nudged = _port_step(v, nudge=True, fused_red=False, compute_dtype="bfloat16")
    loss = abs(got["scalars"]["loss"] - jscal["loss"]) / abs(jscal["loss"])
    update, stats = _update_err(got, jnew)
    s_loss = abs(nudged["scalars"]["loss"] - got["scalars"]["loss"]) / abs(jscal["loss"])
    s_update, s_stats = _update_err(nudged, got)
    print(f"[parity] bf16 step vs JAX bf16 step: loss {loss:.2e} relative, update {update:.2e} "
          f"over all, running statistics {stats:.2e}; the nudged step: {s_loss:.2e}, "
          f"{s_update:.2e}, {s_stats:.2e} (tol {BF16_SPREAD}× those)")
    assert loss <= BF16_SPREAD * s_loss
    assert update <= BF16_SPREAD * s_update and stats <= BF16_SPREAD * s_stats


# ---- remat -------------------------------------------------------------

@pytest.mark.parametrize("model,fused_red", [("red", None), ("red", False), ("casmvs", None)])
def test_remat_step_equals_the_step_without(model, fused_red):
    """remat recomputes each stage's regularizer in the backward: the train
    step's scalars, its update and the running statistics are the bits of
    the step without remat (the recompute leaves the statistics alone, so
    they move once, as flax's nn.remat moves batch_stats), on the fused RED
    pipeline, the RED scan and CasMVS's CostRegNet (train-mode BatchNorm)."""
    ndepths = NDEPTHS if model == "red" else (8, 8, 8)
    tb = tsyn.make_batch(1, W, H, seed=0, device="cpu")
    cfg = Config(model=model, ndepths=ndepths, fused_red=fused_red, seed=3)
    runs = []
    for remat in (False, True):
        m, state, tx = create_model_and_state(cfg, tb, 2)
        m.remat = remat
        calls = []
        m.regs[0].register_forward_pre_hook(lambda *a: calls.append(1))
        state, scalars = make_train_step(m, tx, cfg.dlossw)(state, tb)
        runs.append((state, scalars, len(calls)))
    (s0, sc0, n0), (s1, sc1, n1) = runs
    assert (n0, n1) == (1, 2)  # the regularizer ran again in the backward
    assert all(torch.equal(sc0[k], sc1[k]) for k in sc0)
    assert all(torch.equal(s0.params[k], s1.params[k]) for k in s0.params)
    assert all(torch.equal(s0.batch_stats[k], s1.batch_stats[k]) for k in s0.batch_stats)
    if model == "casmvs":
        fresh = create_model(cfg, "cpu")
        moved = {n: b for n, b in fresh.named_buffers() if n in s1.batch_stats}
        assert any(not torch.equal(moved[n], s1.batch_stats[n]) for n in moved
                   if n.startswith("regs."))


def test_remat_refuses_a_mesh():
    """A train step with remat under a mesh raises (ROADMAP's limits that
    raise)."""
    tb = tsyn.make_batch(1, W, H, seed=0, device="cpu")
    model, _, tx = create_model_and_state(Config(ndepths=NDEPTHS), tb, 2)
    model.remat = True
    with pytest.raises(ValueError, match="remat"):
        make_train_step(model, tx, (0.5, 1.0, 2.0), mesh=object())


@pytest.mark.slow
def test_remat_step_matches_jax_remat():
    """The port's remat step (the fused RED pipeline) against JAX's remat
    step, whose `nn.remat(lambda mdl, v: mdl(v))` sends RED to its scan
    path: the scan-vs-fused gates of tests/test_torch_train_fused.py
    (loss 1e-5 relative, the update 1e-2 over all, running statistics
    1e-6)."""
    jb, args = _jbatch()
    jm = jbuild("red", "rpc", ndepths=NDEPTHS, fused_red=False, remat=True)
    v = _variables(jm, args, 6)
    jnew, jscal = _jax_step(jm, v, jb)
    got = _port_step(v, remat=True)
    loss = abs(got["scalars"]["loss"] - jscal["loss"]) / abs(jscal["loss"])
    update, stats = _update_err(got, jnew)
    print(f"[parity] remat step vs JAX remat step: loss {loss:.2e}, update {update:.2e}, "
          f"running statistics {stats:.2e} (tol 1e-5, 1e-2, 1e-6)")
    assert loss <= 1e-5 and update <= 1e-2 and stats <= 1e-6


# ---- torch_compat ------------------------------------------------------

def test_compat_hypotheses_match_jax():
    """The reference's window chain (`stage_hypotheses(full=)`: the previous
    depth up to full resolution, the window there, a linear resize back)
    against JAX's (jax.image.resize "trilinear", antialias off) at both
    later stages' scales: 1e-6 relative."""
    rng = np.random.default_rng(5)
    for scale, prev_scale in ((2, 4), (1, 2)):
        prev = (400.0 + 30.0 * rng.normal(size=(1, H // prev_scale, W // prev_scale))
                ).astype(np.float32)
        sh, sw = H // scale, W // scale
        cur = jax.vmap(lambda x: jdr.upsample_map(x, H, W))(jnp.asarray(prev))
        full = jax.vmap(lambda c: jdr.window_samples(c, 4, 5.0))(cur)
        want = jax.vmap(lambda t: jax.image.resize(t, (4, sh, sw), method="trilinear",
                                                   antialias=False))(full)
        got = stage_hypotheses(4, sh, sw, None, None, 5.0, torch.from_numpy(prev),
                               full=(H, W))
        direct = np.asarray(jstage_hypotheses(4, sh, sw, None, None, 5.0,
                                              depth=jnp.asarray(prev)))
        err = np.abs(got.numpy() - np.asarray(want)).max() / np.abs(want).max()
        print(f"[parity] torch_compat hypotheses at 1/{scale}: {err:.2e} relative (tol 1e-6); "
              f"the direct window differs by {np.abs(direct - np.asarray(want)).max():.2e} m")
        assert err <= 1e-6


@pytest.fixture(scope="module")
def compat_forward():
    """JAX CascadeREDNet(torch_compat=True) at inference against the port's
    torch_compat model (the fused RED pipeline), full and streaming."""
    jb, args = _jbatch()
    jm = jbuild("red", "rpc", ndepths=NDEPTHS, fused_red=False, torch_compat=True)
    v = _variables(jm, args, 6)
    want = jax.tree.map(np.asarray, jax.jit(lambda v, *a: jm.apply(v, *a, train=False))(
        v, *args))
    tb = tsyn.make_batch(1, W, H, seed=0, device="cpu")
    model = load_jax_variables(CascadeREDNet(ndepths=NDEPTHS, torch_compat=True,
                                             device="cpu"), v)
    native = load_jax_variables(CascadeREDNet(ndepths=NDEPTHS, device="cpu"), v)
    a = (tb["imgs"], tb["cams"], tb["depth_values"])
    return {"want": want, "dv": jb["depth_values"][0], "full": model(*a),
            "native": native(*a),
            "stream": {k: streaming_red_forward(model, *a, slab=k) for k in (0, 4)}}


def test_compat_forward_matches_jax(compat_forward):
    """The torch_compat forward: per-stage depth within the depth gates of
    JAX's torch_compat forward, far closer than the native forward is to
    it (the compat chain moves stages 2-3)."""
    r = compat_forward
    for i in (1, 2, 3):
        err = _depth_err(r["full"], r["want"], r["dv"], i)
        native = _depth_err(r["native"], r["want"], r["dv"], i)
        print(f"[parity] torch_compat forward stage{i}: depth err mean {err.mean():.2e}, p99 "
              f"{np.quantile(err, 0.99):.2e} of step; the native forward's mean "
              f"{native.mean():.2e} (tol {DEPTH_MEAN}, {DEPTH_P99})")
        assert err.mean() <= DEPTH_MEAN and np.quantile(err, 0.99) <= DEPTH_P99
    assert native.mean() > 10 * err.mean()


@pytest.mark.parametrize("slab", [0, 4])
def test_compat_streaming_matches_jax(compat_forward, slab):
    """Streaming with the model's torch_compat (one plane a step, and slabs
    of 4) against JAX's torch_compat forward at the depth gates (JAX's own
    streaming equals its full volume, tests/test_infer.py) and against the
    port's full-volume compat forward within 1e-3 of a step."""
    r = compat_forward
    for i in (1, 2, 3):
        err = _depth_err(r["stream"][slab], r["want"], r["dv"], i)
        own = _depth_err(r["stream"][slab], {k: {"depth": v["depth"].numpy()}
                                             for k, v in r["full"].items() if k[:5] == "stage"},
                         r["dv"], i)
        print(f"[parity] torch_compat streaming slab {slab} stage{i}: vs JAX mean "
              f"{err.mean():.2e}, p99 {np.quantile(err, 0.99):.2e}; vs the full volume max "
              f"{own.max():.2e} of step (tol {DEPTH_MEAN}, {DEPTH_P99}, 1e-3)")
        assert err.mean() <= DEPTH_MEAN and np.quantile(err, 0.99) <= DEPTH_P99
        assert own.max() <= 1e-3


@pytest.mark.slow
def test_compat_step_matches_jax():
    """A torch_compat train step (the RED scan, as JAX's on the CPU) against
    JAX's `make_train_step` with torch_compat=True: the gates of
    tests/test_torch_train.py (loss 1e-5 relative, the update 0.05 over all,
    running statistics 1e-5)."""
    jb, args = _jbatch()
    jm = jbuild("red", "rpc", ndepths=NDEPTHS, fused_red=False, torch_compat=True)
    v = _variables(jm, args, 6)
    jnew, jscal = _jax_step(jm, v, jb)
    got = _port_step(v, fused_red=False, torch_compat=True)
    loss = abs(got["scalars"]["loss"] - jscal["loss"]) / abs(jscal["loss"])
    update, stats = _update_err(got, jnew)
    print(f"[parity] torch_compat step vs JAX: loss {loss:.2e}, update {update:.2e}, running "
          f"statistics {stats:.2e} (tol 1e-5, 0.05, 1e-5)")
    assert loss <= 1e-5 and update <= 0.05 and stats <= 1e-5


def test_compat_step_trains():
    """The torch_compat train step runs on both RED paths and CasMVS, its
    loss finite, its gradient through the compat chain (grad_method
    "through") reaching the earlier stages, and CasMVS's detach holding."""
    tb = tsyn.make_batch(1, W, H, seed=0, device="cpu")
    for model, fr, nd in (("red", None, NDEPTHS), ("red", False, NDEPTHS),
                          ("casmvs", None, (8, 8, 8))):
        cfg = Config(model=model, ndepths=nd, fused_red=fr, torch_compat=True)
        m, state, tx = create_model_and_state(cfg, tb, 2)
        assert m.torch_compat
        out = m.run_cascade(tb["imgs"], tb["cams"], tb["depth_values"], True)
        assert out["stage2"]["depth"].requires_grad
        g = torch.autograd.grad(out["stage3"]["depth"].mean(), out["stage1"]["depth"],
                                allow_unused=True)[0]
        assert (g is None) == (model == "casmvs")
        state, scalars = make_train_step(m, tx, cfg.dlossw)(state, tb)
        assert np.isfinite(float(scalars["loss"]))
