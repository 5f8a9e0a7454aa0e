"""The port stands alone: no module of satmvs_tpu_torch/ (its training
modules included), and none of the scripts that run it on the card
(chip_smoke.py, kernel_ab.py, dp_spread.py), imports JAX, flax, optax, orbax
or the JAX package; its entry points run on the GPU unless the caller asks
for the CPU."""

import ast
from pathlib import Path

import pytest
import torch

from satmvs_tpu_torch.data import synthetic as tsyn
from satmvs_tpu_torch.infer.scene import predict_scene
from satmvs_tpu_torch.models import CascadeREDNet

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "satmvs_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((ROOT / "satmvs_tpu_torch").rglob("*.py")) + [
        ROOT / name for name in ("chip_smoke.py", "kernel_ab.py", "dp_spread.py")]
    assert len(files) > 10
    train = {p.name for p in files if p.parent.name == "train"}
    assert {"config.py", "loop.py", "metrics.py", "checkpoints.py", "logging.py"} <= train
    bad = [
        f"{path.relative_to(ROOT)}: {mod}"
        for path in files
        for mod in _imported_modules(path)
        if mod.split(".")[0] in FORBIDDEN
    ]
    assert not bad, bad


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        CascadeREDNet(ndepths=(8, 4, 4))
    with pytest.raises(RuntimeError, match="CUDA"):
        tsyn.make_batch(1, 64, 32)
    with pytest.raises(RuntimeError, match="CUDA"):
        CascadeREDNet(ndepths=(8, 4, 4), device="cuda")
    model = CascadeREDNet(ndepths=(8, 4, 4), device="cpu")
    batch = tsyn.make_batch(1, 64, 32, device="cpu")
    assert all(p.device.type == "cpu" for p in model.parameters())
    assert batch["imgs"].device.type == "cpu"
    assert batch["cams"][0].ref_inv.device.type == "cpu"


def test_predict_scene_needs_cuda_unless_cpu_is_asked(monkeypatch):
    """Whole-scene prediction puts its inputs on the GPU by default: without
    one it raises before any work, and with device="cpu" it runs there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = tsyn.make_scene(32, 32, seed=0)
    seen = []

    def forward(imgs, cams, dvals):
        seen.append((imgs.device.type, cams[0].ref_inv.device.type, dvals.device.type))
        d = imgs[:, 0, :, :, 0]
        return {"depth": d, "photometric_confidence": torch.ones_like(d)}

    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            predict_scene(forward, scene["images"], scene["rpcs"], tile=32, halo=0, device=device)
    assert not seen
    depth, conf = predict_scene(forward, scene["images"], scene["rpcs"], tile=32, halo=0,
                                device="cpu")
    assert depth.shape == conf.shape == (32, 32)
    assert seen == [("cpu", "cpu", "cpu")]
