"""Reference checkpoint conversion (`satmvs_tpu_torch/train/convert.py`,
`cli/convert_ckpt.py`) on the CPU.  The reference checkout is absent, so
the input is a synthetic state dict in the reference's names
(`chip_smoke.reference_state_dict`, which chip_smoke.py's phase 14 feeds
the converter too): a seeded flax variables tree in the shapes of
`jax.eval_shape(model.init)`, written back into the reference's modules by
inverting the layout rules of `satmvs_tpu/train/convert.py:8-16`.  For
each family the port's conversion equals JAX's `convert_reference_
checkpoint` and the tree it came from, bit for bit, and loads
(`params.load_jax_variables`) into the same model bits; then the CLI
journey: `cli.convert_ckpt` → `cli.predict --torch_compat` (full volume
and streaming), each the bits of a direct torch_compat forward of the
converted weights, and `cli.train --mode=test`."""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from satmvs_tpu.data import synthetic as jsyn
from satmvs_tpu.models import build_model as jbuild
from satmvs_tpu.train import convert as jconvert
from satmvs_tpu_torch.cli import convert_ckpt as cli_convert
from satmvs_tpu_torch.cli import predict as cli_predict
from satmvs_tpu_torch.cli import restore_model
from satmvs_tpu_torch.cli import train as cli_train
from satmvs_tpu_torch.data import formats
from satmvs_tpu_torch.data import synthetic as tsyn
from satmvs_tpu_torch.data.dataset import MVSDataset
from satmvs_tpu_torch.data.loader import Loader
from satmvs_tpu_torch.infer.predict import streaming_red_forward
from satmvs_tpu_torch.params import load_jax_variables
from satmvs_tpu_torch.train import Config, create_model
from satmvs_tpu_torch.train import convert as tconvert

from test_torch_train import seeded

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NDEPTHS = (8, 8, 8)
FAMILIES = ("red", "casmvs", "ucs")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: many small ops, run beside other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def flax_tree(family: str, seed: int = 7) -> dict:
    """A seeded flax variables tree of `family` (numpy arrays; the stages'
    plane counts change no parameter's shape, so it fits any ndepths)."""
    jb = jsyn.make_batch(1, 32, 32, seed=0, with_gt=False)
    jm = jbuild(family, "rpc", ndepths=NDEPTHS, fused_red=False)
    args = (jnp.asarray(jb["imgs"]), jb["cams"], jnp.asarray(jb["depth_values"]))
    return seeded(jax.eval_shape(functools.partial(jm.init, train=False),
                                 jax.random.PRNGKey(0), *args), seed)


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


chip_smoke = _load_chip_smoke()
reference_state_dict = chip_smoke.reference_state_dict


def _same_tree(a, b, path="") -> None:
    assert isinstance(a, dict) == isinstance(b, dict), path
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
        for k in a:
            _same_tree(a[k], b[k], f"{path}/{k}")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.shape == y.shape and np.array_equal(x, y), path


@pytest.mark.parametrize("family", FAMILIES)
def test_conversion_matches_jax_bit_for_bit(family):
    """The port's conversion of the reference state dict equals JAX's and
    the tree it was made from, and both load into the port's model as the
    same bits."""
    tree = flax_tree(family)
    sd = reference_state_dict(tree, family)
    got = tconvert.convert_reference_checkpoint(sd, family, num_stage=3)
    want = jconvert.convert_reference_checkpoint(sd, family, num_stage=3)
    _same_tree(dict(enumerate(got)), dict(enumerate(want)))
    _same_tree({"params": got[0], "batch_stats": got[1]}, tree)
    cfg = Config(model=family, ndepths=NDEPTHS)
    a = create_model(cfg, "cpu", {"params": got[0], "batch_stats": got[1]}).state_dict()
    b = create_model(cfg, "cpu", {"params": want[0], "batch_stats": want[1]}).state_dict()
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("family", FAMILIES)
def test_flax_variables_round_trip(family):
    """`chip_smoke.flax_variables`, phase 14's way from a port model to a
    flax tree, is `params.load_jax_variables` read backwards: the tree of a
    model loaded from a seeded tree is that tree, bit for bit."""
    tree = flax_tree(family)
    model = create_model(Config(model=family, ndepths=NDEPTHS), "cpu", tree)
    _same_tree(chip_smoke.flax_variables(model), tree)


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """A reference checkpoint of a seeded CascadeREDNet at ndepths 8,4,4
    (torch.save({'epoch', 'model'})), converted by `cli.convert_ckpt`, and
    a port-written 32² tree."""
    tmp = tmp_path_factory.mktemp("convert")
    tree = flax_tree("red")
    src = str(tmp / "model_000015.ckpt")
    torch.save({"epoch": 15, "model": reference_state_dict(tree, "red")}, src)
    out = cli_convert.main([f"--src={src}", f"--out={tmp / 'ckpt'}", "--ndepths", "8,4,4",
                            "--epoch", "15"])
    root = str(tmp / "ds")
    tsyn.write_synthetic_dataset(root, num_scenes=1, width=32, height=32, h_amp=40.0,
                                 h_scale=120.0)
    return {"tree": tree, "ckpt": str(tmp / "ckpt"), "out": out, "root": root}


def test_convert_cli_writes_a_port_checkpoint(converted):
    """`cli.convert_ckpt` writes epoch --epoch under --out; restored, it
    holds the tree's weights bit for bit and a fresh optimizer state."""
    assert converted["out"] == os.path.join(converted["ckpt"], "15")
    cfg = Config(ndepths=(8, 4, 4), torch_compat=True)
    model, state, epoch = restore_model(cfg, converted["ckpt"], torch.device("cpu"))
    want = load_jax_variables(create_model(cfg, "cpu"), converted["tree"]).state_dict()
    got = model.state_dict()
    assert epoch == 15 and state.step == 0 and state.opt_state["count"] == 0
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_compat_clis_run_the_converted_checkpoint(converted, monkeypatch, tmp_path):
    """`cli.predict --torch_compat` (full volume and --streaming --slab 2)
    writes the maps of a direct torch_compat forward of the converted
    weights on the same Loader batches, bit for bit; `cli.train
    --mode=test` restores and evaluates them."""
    monkeypatch.setenv("SATMVS_PLATFORM", "cpu")
    root, ckpt = converted["root"], converted["ckpt"]
    cfg = Config(ndepths=(8, 4, 4), torch_compat=True)
    model = load_jax_variables(create_model(cfg, "cpu"), converted["tree"])
    assert model.torch_compat
    ld = Loader(MVSDataset(root, "pred", 3, geo_model="rpc", num_stage=3), batch_size=1,
                device="cpu")
    for extra, fwd in (([], model),
                       (["--streaming", "--slab", "2"],
                        functools.partial(streaming_red_forward, model, slab=2))):
        out = cli_predict.main([f"--dataset_root={root}", f"--loadckpt={ckpt}", "--ndepths",
                                "8,4,4", "--torch_compat", *extra])
        assert len(out["written"]) == 3 and out["epoch"] == 15
        for batch in ld:
            want = fwd(batch["imgs"], batch["cams"], batch["depth_values"])["depth"][0]
            key = (batch["out_view"][0], batch["out_name"][0])
            np.testing.assert_array_equal(formats.load_pfm(out["written"][key]),
                                          want.numpy())
    out = cli_train.main(["--mode=test", f"--dataset_root={root}", f"--logdir={tmp_path}",
                          "--ndepths", "8,4,4", f"--loadckpt={ckpt}"])
    assert out["epoch"] == 15 and np.isfinite(out["metrics"]["loss"])
