"""Checkpoint conversion CLI: the twin of scripts/convert_ckpt.py.

    python -m satmvs_tpu_torch.cli.convert_ckpt --src model_000015.ckpt --model red \
        --out checkpoints/red/rpc [--ndepths 64,32,8] [--epoch 15]

Reads a reference (PyTorch SatMVS) checkpoint, `torch.save({'model':
state_dict, ...})` with or without DataParallel's "module." prefix
(unpickled whole: convert only files you trust), converts it to flax's
names (`train.convert`), loads it into the configured model
(`params.load_jax_variables`, which raises on a key or shape that does not
fit) and writes a port checkpoint (`train.checkpoints`) as epoch --epoch
under --out, with a fresh optimizer state (the reference's RMSprop moments
are not carried over).  `cli.predict --loadckpt OUT --torch_compat` runs
it under the reference's sampling, and `cli.train --mode=test --loadckpt
OUT` restores it too (the train CLI has JAX's flags, which carry no
torch_compat).  Runs on the CPU.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Convert; returns the written checkpoint's directory (--out/--epoch)."""
    import os

    from ..train import Config
    from ..train.checkpoints import save_checkpoint
    from ..train.convert import reference_variables
    from ..train.loop import create_model, make_optimizer, state_of

    p = argparse.ArgumentParser(description="reference checkpoint → port checkpoint")
    p.add_argument("--src", required=True, help="reference .ckpt (torch.save)")
    p.add_argument("--out", required=True, help="port checkpoint directory")
    p.add_argument("--model", default="red", choices=["red", "casmvs", "ucs"])
    p.add_argument("--geo_model", default="rpc", choices=["rpc", "pinhole"])
    p.add_argument("--ndepths", default="64,32,8")
    p.add_argument("--epoch", type=int, default=0, help="epoch label for the save")
    a = p.parse_args(argv)

    cfg = Config(model=a.model, geo_model=a.geo_model,
                 ndepths=tuple(int(x) for x in a.ndepths.split(",") if x), torch_compat=True)
    variables = reference_variables(a.src, a.model, num_stage=cfg.num_stage)
    model = create_model(cfg, "cpu", variables)
    save_checkpoint(a.out, a.epoch, state_of(model, make_optimizer(cfg, 1)))
    out = os.path.join(a.out, str(a.epoch))
    print(f"converted {a.src} → {out}")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
