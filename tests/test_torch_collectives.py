"""The port's collectives report (satmvs_tpu_torch/cli/collectives_report.py)
on the CPU over gloo: one world of two ranks for each of the `data` and
`data_spatial` meshes and one of four for `depth`, each started once for
the module through the CLI's `main` (the smallest sizes and ndepths that
tests/test_torch_dist_shard.py shards: RED at 32×64, ndepths (8, 8, 8), its
rows sharded at stages 2 and 3 under data_spatial; CasMVS at 32×32,
ndepths (32, 8, 8), stage 1's planes on four ranks).

What they hold:
  - the gradient all-reduce is one call of 4 × the parameter count bytes,
    and the parameter count is the JAX model's (`jax.eval_shape` of its
    init, nothing compiled);
  - the BatchNorm, loss and metric all-reduce counts equal the formula
    from the model's layers: each BatchNorm whose moments span ranks
    (FeatureNet's under a data axis above 1, a sharded stage's CostRegNet's)
    once forward and once backward; a loss mask count a stage, one loss
    sum, one metric sum;
  - the exchange buffers' bytes equal the formula for their rows: a halo
    of a 3-D conv of a depth slab ranks × (before + after) planes of the
    conv's input, a slab gather the whole stage volume;
  - every rank's inventory is the others' (op, issuer, count, buffer
    bytes; the useful bytes are each rank's own receipts).
"""

import jax
import numpy as np
import pytest
import torch

from satmvs_tpu_torch.cli import collectives_report
from satmvs_tpu_torch.nn.blocks import BatchNorm
from satmvs_tpu_torch.train import Config, create_model

RUNS = {"data": ("red", 2, "32x64", (8, 8, 8)),
        "data_spatial": ("red", 2, "32x64", (8, 8, 8)),
        "depth": ("red", 4, "32x32", (32, 8, 8))}


@pytest.fixture(scope="module")
def reports():
    """mesh → (main's result, the CPU model of its family)."""
    out = {}
    with pytest.MonkeyPatch.context() as m:
        m.setenv("SATMVS_PLATFORM", "cpu")
        for mesh, (model, devices, size, nd) in RUNS.items():
            res = collectives_report.main(["--devices", str(devices), "--size", size, "--model",
                                           model, "--ndepths", ",".join(map(str, nd)),
                                           "--mesh", mesh])
            out[mesh] = (res, create_model(Config(model=res["model"], ndepths=nd), "cpu"))
    return out


def _rows(res, rank=0) -> dict:
    return {row["issuer"]: row for row in res["ranks"][rank]["inventory"]}


def _jax_params(model: str, size: str, nd) -> int:
    from satmvs_tpu.data import synthetic as jsyn
    from satmvs_tpu.models import build_model
    from satmvs_tpu.train.loop import numeric_batch

    h, w = (int(x) for x in size.split("x"))
    b = numeric_batch(jsyn.make_batch(batch_size=1, width=w, height=h, seed=0))
    jmodel = build_model(model, "rpc", ndepths=nd)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), b["imgs"], b["cams"],
                                                b["depth_values"], train=False))
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes["params"]))


@pytest.mark.parametrize("mesh", list(RUNS))
def test_gradient_all_reduce_is_four_bytes_a_jax_parameter(reports, mesh):
    res, _ = reports[mesh]
    _, devices, size, nd = RUNS[mesh]
    params = res["ranks"][0]["params"]
    grads = _rows(res)["gradients"]
    assert (grads["op"], grads["count"], grads["dtype"]) == ("all_reduce", 1, "float32")
    assert grads["bytes"] == grads["useful_bytes"] == 4 * params
    assert grads["group_size"] == devices
    assert params == _jax_params(res["model"], size, nd)
    assert res["model"] == ("casmvs" if mesh == "depth" else "red")


def _sharded_stages(rank: dict) -> list[int]:
    return [i for i, spec in enumerate(rank["volume_partition"]) if spec[1] or spec[2]]


@pytest.mark.parametrize("mesh", list(RUNS))
def test_batchnorm_loss_and_metric_counts_follow_the_layers(reports, mesh):
    res, model = reports[mesh]
    r0 = res["ranks"][0]
    n_stages = len(RUNS[mesh][3])
    synced = (sum(isinstance(m, BatchNorm) for m in model.feature.modules())
              if r0["mesh"]["data"] > 1 else 0)
    synced += sum(isinstance(m, BatchNorm) for i in _sharded_stages(r0)
                  for m in model.regs[i].modules())
    rows = _rows(res)
    count = {k: rows[k]["count"] if k in rows else 0 for k in
             ("batchnorm moments", "batchnorm moments (backward)", "loss mask counts",
              "loss sums", "metric sums")}
    print(f"[collectives] {mesh}: {count}, {synced} BatchNorms across ranks")
    assert count == {"batchnorm moments": synced, "batchnorm moments (backward)": synced,
                     "loss mask counts": n_stages, "loss sums": 1, "metric sums": 1}
    assert (mesh == "data") == (synced == 12)  # FeatureNet's twelve, RED has none


def test_depth_halos_move_their_planes(reports):
    """Each 3-D conv of the sharded stage's CostRegNet, in its order, takes
    one halo exchange forward and one backward, of 4 ranks × (before +
    after) planes of its input: stride 1 a plane each side, stride 2 one
    before, the transposed conv one after."""
    res, model = reports["depth"]
    r0 = res["ranks"][0]
    assert _sharded_stages(r0) == [0]
    assert [s[1] for s in r0["volume_partition"]] == ["depth", None, None]
    h, w = (int(x) // 4 for x in RUNS["depth"][2].split("x"))  # stage 1 at 1/4
    reg, level, want = model.regs[0], 0, []
    layers = [*(blk.conv for blk in reg.convs), *(blk.conv for blk in reg.deconvs), reg.head]
    for conv in layers:
        transposed = isinstance(conv, torch.nn.ConvTranspose3d)
        stride = conv.stride[0]
        planes = 1 if transposed or stride == 2 else 2
        want.append(4 * planes * conv.in_channels * (h >> level) * (w >> level) * 4)
        level += -1 if transposed else (1 if stride == 2 else 0)
    calls = r0["calls"]
    got = [c["bytes"] for c in calls if c["issuer"] == "halo exchange"]
    back = [c["bytes"] for c in calls if c["issuer"] == "halo exchange (backward)"]
    assert got == want and sorted(back) == sorted(want)
    assert all(c["group_size"] == 4 for c in calls if c["issuer"].startswith("halo"))
    rows = _rows(res)
    assert rows["group max"]["count"] == 1


def test_spatial_slab_gathers_move_whole_stage_volumes(reports):
    """RED under data_spatial gathers each sharded stage's banded volume
    along its rows: B × C × D × H × W float32 of the stage, once forward
    and once backward; a rank's useful share is the other rank's band."""
    res, model = reports["data_spatial"]
    r0 = res["ranks"][0]
    assert _sharded_stages(r0) == [1, 2]
    h, w = (int(x) for x in RUNS["data_spatial"][2].split("x"))
    nd = RUNS["data_spatial"][3]
    chans = [model.feature.out_channels[i] for i in range(3)]
    want = [chans[i] * nd[i] * (h >> (2 - i)) * (w >> (2 - i)) * 4 for i in (1, 2)]
    calls = r0["calls"]
    for issuer in ("slab gather", "slab gather (backward)"):
        got = [c["bytes"] for c in calls if c["issuer"] == issuer]
        assert sorted(got) == sorted(want), issuer
        assert sum(c["useful_bytes"] for c in calls if c["issuer"] == issuer) == sum(want) // 2


@pytest.mark.parametrize("mesh", list(RUNS))
def test_every_rank_records_the_same_inventory(reports, mesh):
    res, _ = reports[mesh]
    key = ("op", "issuer", "dtype", "group_size", "count", "bytes")
    inv = [[tuple(row[k] for k in key) for row in r["inventory"]] for r in res["ranks"]]
    assert all(i == inv[0] for i in inv[1:])
    assert len({r["loss"] for r in res["ranks"]}) == 1  # the global batch's loss everywhere
    assert res["ranks"][0]["mesh"] == dict(zip(
        ("data", "spatial", "depth"), collectives_report.mesh_shape(mesh, RUNS[mesh][1])))

