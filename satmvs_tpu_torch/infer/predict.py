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

from ..models.cascade import CascadeModel, build_stage_volume, stage_hypotheses


@torch.no_grad()
def streaming_red_forward(model: CascadeModel, imgs: torch.Tensor, cams, depth_values: torch.Tensor,
                          slab: int = 0) -> dict:
    """`model`'s forward (same inputs, same outputs) with slab streaming.

    slab: planes per step.  A stage of nd planes takes k = min(slab, nd)
    planes a step when nd % k == 0, else (and with slab = 0) one plane at a
    time; every step runs the same kernels.  Load trained weights into
    `model` with `params.load_jax_variables` (the flax `ScanREDStep_0` trees
    of every stage map onto `model.regs`).
    """
    if model.regularizer != "red":
        raise ValueError(f"streaming_red_forward: a {model.regularizer!r} model has no "
                         f"slab-streaming form; run its full-volume forward")
    d_min, d_max = depth_values[:, 0], depth_values[:, -1]
    outputs = {}
    depth = None
    for i, feats in enumerate(model.features(imgs)):
        b, _, sh, sw, _ = feats.shape
        nd = model.ndepths[i]
        hyps = stage_hypotheses(nd, sh, sw, d_min, d_max, model.stage_intervals()[i], depth)
        k = min(slab, nd) if slab else 1
        if nd % k:
            k = 1
        m = torch.full((b, sh, sw), -torch.inf, device=feats.device)
        s = torch.zeros((b, sh, sw), device=feats.device)
        ds = torch.zeros((b, sh, sw), device=feats.device)
        states = None
        for j in range(0, nd, k):
            hyp = hyps[:, j:j + k]
            volume = build_stage_volume(feats, cams[i], hyp)
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
