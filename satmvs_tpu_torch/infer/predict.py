"""Streaming tile inference: the depth planes of every stage in slabs, with
an online softmax.

Counterpart of `satmvs_tpu/infer/predict.py:streaming_red_forward`.  Per
cascade stage the D hypothesis planes go through in slabs of k planes: the
slab's cost volume (`sweep_variance`), the RED pipeline seeded with the GRU
states the previous slab handed on (`nn/red.REDRegularizer.pipeline`), and a
merge into max-shifted online-softmax sums.  Memory is O(k·H·W) in D,
whatever D is; the result is the full-volume forward's.

The online softmax carries the running max m, s = Σ exp(l − m) and
ds = Σ d·exp(l − m), exact in float32 for any logit range (the reference
sums raw exp(l) in float64).  Depth = ds / s; confidence, the max-plane
probability, = 1 / s since exp(m − m) = 1.
"""

from __future__ import annotations

import torch

from ..models.cascade import CascadeModel, build_stage_volume


@torch.no_grad()
def streaming_red_forward(model: CascadeModel, imgs: torch.Tensor, cams, depth_values: torch.Tensor,
                          slab: int = 0, coords: str | None = None) -> dict:
    """`model`'s forward (same inputs, same outputs) with slab streaming;
    cams of any of the model's camera types (RPC in either form, pinhole
    projection matrices), each slab's volume built by `build_stage_volume`
    under the model's knobs: its torch_compat (the reference's sampling and
    window chain, as `satmvs_tpu/infer/predict.py:120-130,177,207`) and its
    compute_dtype (FeatureNet; the RED pipeline is float32 either way).

    coords: "exact" or "coarse" sweep coordinates (None: the model's).
    With coarse coordinates the first stage's planes are evaluated exactly
    per plane, as in the full volume, and each later slab's hypotheses
    centre their own quadratic height fit, as each of JAX's slab calls of
    `build_stage_volume` does, so the streamed maps differ from the
    full-volume forward's by up to the coarse grid's error (≤ 0.02 px of
    sampling position), not bit for bit.

    slab: planes per step.  A stage of nd planes takes k = min(slab, nd)
    planes a step when nd % k == 0, else (and with slab = 0) one plane at a
    time; every step runs the same kernels.  Load trained weights into
    `model` with `params.load_jax_variables` (the flax `ScanREDStep_0` trees
    of every stage map onto `model.regs`).  One stage or three, as the
    model has; regularizers that do not match its ndepths raise, as JAX's
    checkpoint check does (`satmvs_tpu/infer/predict.py:96-99`).
    """
    if model.regularizer != "red":
        raise ValueError(f"streaming_red_forward: a {model.regularizer!r} model has no "
                         f"slab-streaming form; run its full-volume forward")
    if len(model.regs) != len(model.ndepths):
        raise ValueError(f"the model has {len(model.regs)} RED stages, its ndepths "
                         f"{model.ndepths} ask {len(model.ndepths)}")
    coords = model.coords if coords is None else coords
    d_min, d_max = depth_values[:, 0], depth_values[:, -1]
    outputs = {}
    depth = None
    for i, feats in enumerate(model.features(imgs)):
        b, _, sh, sw, _ = feats.shape
        nd = model.ndepths[i]
        hyps = model.hypotheses(i, sh, sw, d_min, d_max, depth, None)
        k = min(slab, nd) if slab else 1
        if nd % k:
            k = 1
        m = torch.full((b, sh, sw), -torch.inf, device=feats.device)
        s = torch.zeros((b, sh, sw), device=feats.device)
        ds = torch.zeros((b, sh, sw), device=feats.device)
        states = None
        for j in range(0, nd, k):
            hyp = hyps[:, j:j + k]
            window = hyp[:, :, 0, 0] if depth is None and coords == "coarse" else None
            volume = build_stage_volume(feats, cams[i], hyp, 0, coords, model.convention, window)
            logits, states = model.regs[i].pipeline(volume, states)
            new_m = torch.maximum(m, logits.amax(dim=1))
            rescale = torch.exp(m - new_m)
            p = torch.exp(logits - new_m[:, None])
            s = s * rescale + p.sum(dim=1)
            ds = ds * rescale + (hyp * p).sum(dim=1)
            m = new_m
        depth = ds / s.clamp(min=1e-10)
        outputs[f"stage{i + 1}"] = {"depth": depth,
                                    "photometric_confidence": 1.0 / s.clamp(min=1e-10)}
    outputs.update(outputs[f"stage{len(model.ndepths)}"])
    return outputs
