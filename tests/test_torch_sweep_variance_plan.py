"""The cost-volume sweep on the CPU (satmvs_tpu_torch/ops/kernels/sweep_variance.py,
CUDA `sweep_variance_kernel` of csrc/sweep_variance.cu): the launch plan's
thread-to-output map, written out here from the kernel's index arithmetic,
covers every (sample, plane, pixel, channel) exactly once at the forward's,
the scene chunk's and the `cuda` tests' shapes, and its refusals; the
batched entry's plain version is the per-sample one; `build_stage_volume` at
B = 2 is two B = 1 calls; the batched wrapper's refusals; the backward
kernel's plan (`sweep_variance_backward_plan`) covers every output once.
The kernels themselves run only on the card (tests/test_torch_kernels.py,
`cuda`)."""

import numpy as np
import pytest
import torch

from satmvs_tpu_torch.data import synthetic
from satmvs_tpu_torch.models.cascade import build_stage_volume, stage_hypotheses
from satmvs_tpu_torch.ops import warp
from satmvs_tpu_torch.ops.kernels import sweep_variance as sv

# (B, S, D, H, W, C): a 384×768 forward's three sweeps, a 4-tile scene
# chunk's (448² tiles, 8-plane slabs) and the `cuda` tests' shapes
FORWARD_SHAPES = [(1, 2, 64, 96, 192, 32), (1, 2, 32, 192, 384, 16), (1, 2, 8, 384, 768, 8)]
CHUNK_SHAPES = [(4, 2, 8, 112, 112, 32), (4, 2, 8, 224, 224, 16), (4, 2, 8, 448, 448, 8)]
CARD_SHAPES = [(3, 2, 5, 12, 20, 6), (2, 2, 8, 16, 24, 8), (2, 2, 4, 9, 13, 16),
               (4, 2, 3, 7, 33, 32), (2, 3, 5, 7, 9, 12), (1, 2, 1, 1, 1, 4),
               (1, 2, 32, 24, 48, 32), (2, 2, 8, 40, 200, 8), (4, 2, 8, 56, 56, 32),
               (1, 2, 3, 10, 14, 8), (1, 2, 3, 10, 14, 32), (1, 2, 3, 10, 14, 6)]


def _covered(plan, b, d, h, w, c):
    """Count of each (sample, plane, pixel, channel) the kernel writes under
    `plan`: block (tile, run, sample) of grid (tiles, runs of K planes, B),
    thread t = lane + lanes·(px + tx·row); pixel (tile // ntx · ty + row,
    tile % ntx · tx + px) when inside the plane; planes run·K .. run·K + K − 1
    below D; channels lane·vec + g·lanes·vec + i.  The map is a product of
    the pixel, plane and channel maps, so each is counted on its own and the
    product is every output once iff each factor is."""
    vec, groups, k, lanes = plan["vec"], plan["groups"], plan["planes"], plan["lanes"]
    tx, ty, threads = plan["tx"], plan["ty"], plan["threads"]
    tiles, runs, nb = plan["grid"]
    assert threads == lanes * tx * ty <= sv.SWEEP_THREADS and lanes * vec * groups == c
    assert nb == b and runs == -(-d // k)
    ntx = -(-w // tx)
    assert tiles == -(-h // ty) * ntx
    tile, t = np.meshgrid(np.arange(tiles), np.arange(threads), indexing="ij")
    lane, q = t % lanes, t // lanes
    row, px = q // tx, q % tx
    y, x = tile // ntx * ty + row, tile % ntx * tx + px
    inside = (y < h) & (x < w)
    pix = np.bincount((y * w + x)[inside] * lanes + lane[inside], minlength=h * w * lanes)
    run, kk = np.meshgrid(np.arange(runs), np.arange(k), indexing="ij")
    planes = (run * k + kk)[run * k + kk < d]
    chans = (np.arange(lanes)[:, None, None] * vec
             + np.arange(groups)[None, :, None] * lanes * vec + np.arange(vec)[None, None, :])
    return pix, np.bincount(planes, minlength=d), np.bincount(chans.ravel(), minlength=c)


@pytest.mark.parametrize("shape", FORWARD_SHAPES + CHUNK_SHAPES + CARD_SHAPES)
def test_every_plan_writes_every_output_once(shape):
    b, s, d, h, w, c = shape
    options = sv.sweep_variance_plan_options(*shape)
    chosen = sv.sweep_variance_plan(*shape)
    assert chosen in options
    for plan in options:
        pix, planes, chans = _covered(plan, b, d, h, w, c)
        assert (pix == 1).all() and (planes == 1).all() and (chans == 1).all(), plan
    # the chosen plan at the path's shapes: two float4 groups and eight planes a thread
    if shape in FORWARD_SHAPES + CHUNK_SHAPES:
        assert (chosen["vec"], chosen["groups"], chosen["planes"]) == (4, 2, 8)
        assert chosen["threads"] == sv.SWEEP_THREADS


# the backward's: a train step's three sweeps and the `cuda` tests' shapes
BACKWARD_SHAPES = FORWARD_SHAPES + [(2, s, 7, 13, 21, c) for s in (2, 5) for c in (6, 8, 16, 32)]


@pytest.mark.parametrize("shape", BACKWARD_SHAPES)
def test_backward_plan_writes_every_output_once(shape):
    """sweep_variance_backward's plan: one group of vec channels a thread,
    every thread walking all D planes (one run: the reference's cotangent is
    summed over the planes by one thread), every (sample, pixel, channel)
    once, at most SWEEP_THREADS a block; refused where the forward's plan
    is."""
    b, s, d, h, w, c = shape
    plan = sv.sweep_variance_backward_plan(*shape)
    assert plan["groups"] == 1 and plan["planes"] == d and plan["grid"][1:] == (1, b)
    assert plan["vec"] == sv.sweep_variance_plan(*shape)["vec"]
    pix, planes, chans = _covered(plan, b, d, h, w, c)
    assert (pix == 1).all() and (planes == 1).all() and (chans == 1).all()
    with pytest.raises(ValueError, match="source views"):
        sv.sweep_variance_backward_plan(b, 0, d, h, w, c)


def test_plan_options_follow_the_kernel_instances():
    """vec 4 only for C % 4 == 0 and aligned operands; two groups only for
    C % 8 == 0 and at most two source views; planes at most D."""
    assert {o["vec"] for o in sv.sweep_variance_plan_options(1, 2, 4, 8, 8, 6)} == {1}
    assert {o["vec"] for o in sv.sweep_variance_plan_options(1, 2, 4, 8, 8, 8, False)} == {1}
    assert {o["groups"] for o in sv.sweep_variance_plan_options(1, 2, 4, 8, 8, 12)} == {1}
    assert {o["groups"] for o in sv.sweep_variance_plan_options(1, 3, 4, 8, 8, 16)} == {1}
    assert {o["groups"] for o in sv.sweep_variance_plan_options(1, 2, 4, 8, 8, 16)} == {1, 2}
    assert {o["planes"] for o in sv.sweep_variance_plan_options(1, 2, 3, 8, 8, 8)} == {1, 2, 3}


@pytest.mark.parametrize("shape,match", [
    ((0, 2, 4, 8, 8, 8), "empty"), ((1, 2, 0, 8, 8, 8), "empty"), ((1, 0, 4, 8, 8, 8), "views"),
    ((65536, 2, 1, 1, 1, 4), "65535"),
    ((1, 2, 4, 8, 8, 1025 * 4), "threads"), ((1, 2, 4, 8, 8, 257), "threads"),
    ((1, 2, 4, 2 ** 14, 2 ** 14, 8), "32-bit"), ((1, 2, 2 ** 20, 8, 8, 8), "too large")])
def test_plan_refuses_what_the_kernel_cannot_take(shape, match):
    with pytest.raises(ValueError, match=match):
        sv.sweep_variance_plan(*shape)


@pytest.mark.parametrize("shape", [(2, 5, 5, 12, 20, 8), (1, 5, 8, 96, 192, 32),
                                   (2, 8, 3, 7, 33, 12), (3, 8, 4, 9, 13, 6)])
def test_plan_takes_more_than_four_views(shape):
    """Beyond four source views the kernel walks them in groups of four
    (`sweep_variance_groups_kernel`): one channel group a thread, the same
    grid and thread map, every output written once under every plan."""
    b, s, d, h, w, c = shape
    options = sv.sweep_variance_plan_options(*shape)
    assert options and {o["groups"] for o in options} == {1}
    assert sv.sweep_variance_plan(*shape) in options
    for plan in options:
        pix, planes, chans = _covered(plan, b, d, h, w, c)
        assert (pix == 1).all() and (planes == 1).all() and (chans == 1).all(), plan


def _batch(b=3, s=2, d=4, h=9, w=13, c=8, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(b, s + 1, h, w, c)).astype(np.float32)
    xs = rng.uniform(-2, w + 1, (b, s, d, h, w)).astype(np.float32)
    ys = rng.uniform(-2, h + 1, (b, s, d, h, w)).astype(np.float32)
    return [torch.from_numpy(a) for a in (feats, xs, ys)]


def test_batched_plain_version_is_the_per_sample_one():
    feats, xs, ys = _batch()
    before = sv.sweep_variance.launches
    got = sv.sweep_variance_batched(feats, xs, ys)
    assert sv.sweep_variance.launches == before  # CPU tensors: the plain version
    assert got.shape == (3, 4, 9, 13, 8) and got.dtype == torch.float32
    for i in range(3):
        assert torch.equal(got[i], sv.sweep_variance(feats[i, 0], feats[i, 1:], xs[i], ys[i]))
    assert torch.equal(got, sv.sweep_variance_batched_reference(feats, xs, ys))


def test_batched_wrapper_rejects_what_the_kernel_does_not_take():
    feats, xs, ys = _batch()
    with pytest.raises(TypeError):
        sv.sweep_variance_batched(feats.double(), xs, ys)
    with pytest.raises(TypeError):
        sv.sweep_variance_batched(feats, xs, ys.half())
    with pytest.raises(ValueError, match="feats"):
        sv.sweep_variance_batched(feats[0], xs, ys)
    with pytest.raises(ValueError):
        sv.sweep_variance_batched(feats[:, :2], xs, ys)  # one source view, coordinates for two
    with pytest.raises(ValueError):
        sv.sweep_variance_batched(feats[:2], xs, ys)  # two samples, coordinates for three
    with pytest.raises(ValueError):
        sv.sweep_variance_batched(feats, xs, ys[:, :, :2])
    with pytest.raises(ValueError):
        sv.sweep_variance_batched(feats, xs[0], ys[0])


def test_build_stage_volume_batch_of_two_is_two_single_calls():
    """Two samples (their own cameras, features and window hypotheses) in one
    call give each sample's B = 1 volume bit for bit."""
    size, nd = 16, 4
    rng = np.random.default_rng(4)
    cams = [warp.build_rpc_warp_cams(
        np.stack([t[2], t[0], t[1]]), 0, 0.25, device="cpu")
        for t in (synthetic.make_rpc_triplet(4 * size, 4 * size, seed=i) for i in range(2))]
    batched = warp.stack_cams(cams)
    feats = torch.from_numpy(rng.normal(size=(2, 3, size, size, 8)).astype(np.float32))
    prev = torch.from_numpy(rng.uniform(200, 300, (2, size // 2, size // 2)).astype(np.float32))
    hyps = stage_hypotheses(nd, size, size, torch.tensor([100.0, 120.0]),
                            torch.tensor([400.0, 420.0]), 5.0, prev)
    with torch.no_grad():
        both = build_stage_volume(feats, batched, hyps)
        singles = [build_stage_volume(feats[i:i + 1], warp.stack_cams([cams[i]]), hyps[i:i + 1])
                   for i in range(2)]
    assert both.shape == (2, nd, size, size, 8)
    for i in range(2):
        assert torch.equal(both[i], singles[i][0])
