"""The port's tool twins (satmvs_tpu_torch/cli/{fusion_sweep,synthetic_e2e,
profile_forward}.py) against the JAX package's scripts, on the CPU.

  - fusion_sweep: the port's rows against JAX's `scripts/fusion_sweep.main()`
    (run with its argv, its JSON lines captured) on seeded noisy 3-view
    height maps of a 64² scene of the port's writer, with a confidence map
    and ground truth: the same settings, valid_pct within 0.01 pp and
    mae_m / lt2.5m_pct within 1e-3 (tests/test_torch_fuse.py's gates: the
    two filters' masks differ only at threshold edges);
  - synthetic_e2e: a run at --scenes 2 --test_scenes 1 --epochs 1 --size 64
    --ndepths 8,8,8 prints one JSON line with exactly the JAX script's
    keys, all finite, and its fused_mae_m / fusion_valid_frac are JAX's
    lines 132-135 computed by hand (JAX's filter) on the maps it fused;
  - profile_forward: the cost-map rule on the names of the port's kernels
    and of the libraries' as the profiler shows them, and a CPU run at
    32×64 whose pools sum to its total.
"""

import importlib.util
import json
import math
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from satmvs_tpu.infer import fuse as jfuse
from satmvs_tpu_torch.cli import fusion_sweep, profile_forward, synthetic_e2e
from satmvs_tpu_torch.data import formats, synthetic

ROOT = Path(__file__).resolve().parents[1]
JAX_E2E_KEYS = ("test_mae_m", "acc_1.0m", "acc_2.5m", "acc_7.5m", "acc_3interval",
                "fused_mae_m", "fusion_valid_frac", "train_seconds", "epochs", "scenes")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: many small ops, run beside other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("SATMVS_PLATFORM", "cpu")


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def sweep_inputs(tmp_path_factory):
    """Noisy per-view heights (views 2, 0, 1: reference first; 1.5 m noise,
    3 % gross errors), their RPC files, a confidence map and view 2's
    ground truth, from one 64² scene of the port's writer."""
    d = tmp_path_factory.mktemp("sweep")
    root = str(d / "tree")
    synthetic.write_synthetic_dataset(root, num_scenes=1, width=64, height=64, seed=4,
                                      h_amp=60.0, h_scale=150.0)
    rng = np.random.default_rng(11)
    views, rpcs = [], []
    for v in ("2", "0", "1"):
        h = formats.load_pfm(os.path.join(root, "height", v, "scene0000.pfm"))
        noisy = h + rng.normal(0.0, 1.5, h.shape).astype(np.float32)
        gross = rng.random(h.shape) < 0.03
        noisy[gross] += rng.uniform(-80.0, 80.0, int(gross.sum())).astype(np.float32)
        views.append(str(d / f"h_view{v}.pfm"))
        formats.save_pfm(views[-1], noisy.astype(np.float32))
        rpcs.append(os.path.join(root, "rpc", v, "scene0000.rpc"))
    prob = str(d / "prob.pfm")
    formats.save_pfm(prob, rng.random((64, 64)).astype(np.float32))
    gt = str(d / "gt.npy")
    np.save(gt, formats.load_pfm(os.path.join(root, "height", "2", "scene0000.pfm")))
    return ["--views", *views, "--rpcs", *rpcs, "--prob", prob, "--gt", gt,
            "--p_ratio", "1", "2", "--d_ratio", "2.5", "7.5", "--geo_consist", "1", "2", "3",
            "--confidence", "0", "0.3"]


def test_fusion_sweep_rows_match_jax(sweep_inputs, monkeypatch, capsys, tmp_path):
    out = str(tmp_path / "rows.jsonl")
    got = fusion_sweep.main([*sweep_inputs, "--out", out])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert printed == got == [json.loads(line) for line in open(out)]
    monkeypatch.setattr("sys.argv", ["fusion_sweep.py", *sweep_inputs])
    _jax_script("fusion_sweep").main()
    want = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert len(got) == len(want) == 2 * 2 * 2 * 2  # geo_consist 3 > 2 source views: skipped
    worst = {"valid_pct": 0.0, "mae_m": 0.0, "lt2.5m_pct": 0.0}
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"p_ratio", "d_ratio", "geo_consist", "confidence",
                                    "valid_pct", "mae_m", "lt2.5m_pct"}
        assert [g[k] for k in ("p_ratio", "d_ratio", "geo_consist", "confidence")] == \
               [w[k] for k in ("p_ratio", "d_ratio", "geo_consist", "confidence")]
        for key in worst:
            worst[key] = max(worst[key], abs(g[key] - w[key]))
    print(f"[parity] fusion_sweep over {len(got)} settings: {worst} "
          f"(tol valid_pct 0.01, mae_m 1e-3, lt2.5m_pct 1e-3)")
    assert 0 < min(g["valid_pct"] for g in got) < max(g["valid_pct"] for g in got) < 100
    assert worst["valid_pct"] <= 0.01 + 1e-9
    assert worst["mae_m"] <= 1e-3 + 1e-9 and worst["lt2.5m_pct"] <= 1e-3 + 1e-9


def test_fusion_sweep_refusals(sweep_inputs):
    views = sweep_inputs[sweep_inputs.index("--views") + 1:sweep_inputs.index("--rpcs")]
    with pytest.raises(SystemExit):
        fusion_sweep.main(["--views", *views, "--rpcs", views[0]])


def test_synthetic_e2e_line_has_jax_keys_and_jax_fusion(tmp_path, capsys):
    res = synthetic_e2e.main(["--scenes", "2", "--test_scenes", "1", "--epochs", "1",
                              "--size", "64", "--ndepths", "8,8,8",
                              "--workdir", str(tmp_path / "e2e")])
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert tuple(line) == JAX_E2E_KEYS
    assert all(isinstance(v, (int, float)) and math.isfinite(v) for v in line.values())
    assert {k: res[k] for k in JAX_E2E_KEYS} == line
    assert (line["epochs"], line["scenes"]) == (1, 2)
    assert res["timing"]["epochs"] == [1] and res["timing"]["steps"] == [2]
    # JAX's lines 132-135 by hand on the maps the run fused
    eroot = os.path.join(res["workdir"], "test")
    rpcs = np.stack([formats.load_rpc(os.path.join(eroot, "rpc", v, "scene0000.rpc"))[0]
                     for v in ("2", "0", "1")])
    mask, fused = jfuse.filter_depth_rpc(res["depths"], rpcs, p_ratio=2.0, d_ratio=7.5,
                                         geo_consist_num=1)
    mask, fused = np.asarray(mask), np.asarray(fused)
    gt = formats.load_pfm(os.path.join(eroot, "height", "2", "scene0000.pfm"))
    err = np.abs(fused - gt)[mask]
    fused_mae = float(np.mean(err[err < 250])) if err.size else float("nan")
    print(f"[parity] e2e fusion: valid {line['fusion_valid_frac']} vs JAX {mask.mean():.4f}, "
          f"MAE {line['fused_mae_m']} vs JAX {fused_mae:.4f} (tol 1e-4, 1e-3)")
    assert abs(line["fusion_valid_frac"] - float(mask.mean())) <= 1e-4 + 5e-5
    assert abs(line["fused_mae_m"] - fused_mae) <= 1e-3 + 5e-4


PORT_KERNELS = {
    profile_forward.SWEEP_POOL: [
        "void sweep_variance_kernel<4, 2, 2>(float const*, float const*, float const*, float*)",
        "void sweep_variance_groups_kernel<4>(float const*, int, float*)",
        "void sweep_variance_backward_kernel<4, 2>(float const*, float*)",
        "sweep_variance_backward_groups_kernel", "void sweep_gather_kernel<float>(float const*)",
        "void sweep_scatter_kernel<__nv_bfloat16>(float*)"],
    profile_forward.RED_POOL: [
        "void red_recur_kernel<8>(float const*, float*)", "red_recur_bwd_kernel",
        "void conv3x3_kernel<2, 4, 0, 8>(float const*, float*)",
        "void deconv3x3_s2_kernel<2, 8, 1>(float const*, float*)",
        "wgrad_partial_kernel", "void wgrad_reduce_kernel(float const*, float*, int)",
        "void (anonymous namespace)::conv3d_block_kernel<false, 1, 8, 4>((anonymous "
        "namespace)::Args)"],
    profile_forward.LIBRARY_POOL: [
        "sm90_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nhwckrsc_nchw_tilesize128x128x16",
        "void cudnn::cnn::conv2d_grouped_direct_kernel<false, true, false, false>(...)",
        "void implicit_convolve_sgemm<float, float, 128, 5, 5, 3, 3, 3, 1, false>(int)",
        "sm80_xmma_dgrad_implicit_gemm_indexed_f32f32_tf32f32_f32_nchwkcrs_nchw",
        "void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64_8x5_nn_align1>(...)",
        "ampere_sgemm_64x32_sliced1x4_nn", "void nchwToNhwcKernel<float, float, float>(int)",
        "aten::mkldnn_convolution"],
    profile_forward.COPY_POOL: [
        "void at::native::(anonymous namespace)::CatArrayBatchedCopy<float, unsigned int, 4>",
        "Memcpy HtoD (Pageable -> Device)", "Memset (Device)",
        "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<"
        "at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)>>", "aten::copy_",
        "aten::cat"],
    profile_forward.OTHER_POOL: [
        "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>",
        "void at::native::vectorized_elementwise_kernel<4, at::native::sigmoid_kernel_cuda>",
        "aten::mul", "aten::native_group_norm"],
}


def test_profile_bucket_rule_on_kernel_names():
    for pool, names in PORT_KERNELS.items():
        for name in names:
            assert profile_forward.bucket(name) == pool, name
    assert set(PORT_KERNELS) == set(profile_forward.POOLS)


def test_profile_forward_pools_sum_to_the_total(tmp_path):
    res = profile_forward.main(["--size", "32x64", "--ndepths", "8,8,8", "--iters", "1",
                                "--trace_dir", str(tmp_path / "trace")])
    pools = res["pools"]
    assert set(pools) == set(profile_forward.POOLS)
    assert res["total_ms"] > 0 and res["wall_ms"] >= res["total_ms"] * 0.5
    assert sum(ms for ms, _ in pools.values()) == pytest.approx(res["total_ms"], rel=1e-9)
    assert sum(n for _, n in pools.values()) == res["count"]
    assert pools[profile_forward.LIBRARY_POOL][0] > 0  # FeatureNet's convolutions
    assert res["top"] and res["top"][0][1] >= res["top"][-1][1]
    assert json.load(open(res["trace"]))["traceEvents"]
