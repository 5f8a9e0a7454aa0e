"""Hand-written CUDA kernels (csrc/) with their wrappers and plain versions.

No module here imports a compiler or builds anything when it is imported:
kernels are compiled at first launch (`build.load`).
"""


def wrappers() -> dict:
    """name → (wrapper, the attribute that counts its kernel's launches) of
    every hand-written kernel; the sweep pair's bf16 instances count apart
    (`<name>_bf16`)."""
    from . import plane_conv as pc
    from . import red_recur as rr
    from .conv3d_block import conv3d_block, deconv3d_block
    from .sweep_gather import sweep_gather, sweep_scatter
    from .sweep_variance import sweep_variance, sweep_variance_backward

    fns = {"sweep_variance": sweep_variance, "conv_dn": pc.conv_dn, "red_recur": rr.red_recur,
           "deconv_up": pc.deconv_up, "conv_head": pc.conv_head, "sweep_gather": sweep_gather,
           "sweep_scatter": sweep_scatter, "conv_dn_backward": pc.conv_dn_backward,
           "red_recur_backward": rr.red_recur_backward,
           "deconv_up_backward": pc.deconv_up_backward,
           "conv_head_backward": pc.conv_head_backward, "wgrad3x3": pc.wgrad3x3,
           "sweep_variance_backward": sweep_variance_backward, "conv3d_block": conv3d_block,
           "deconv3d_block": deconv3d_block}
    out = {k: (f, "launches") for k, f in fns.items()}
    out.update({f"{k}_bf16": (fns[k], "launches_bf16") for k in ("sweep_gather", "sweep_scatter")})
    return out


def launch_counts() -> dict:
    """name → the kernel launches its wrapper has counted in this process."""
    return {name: getattr(fn, attr) for name, (fn, attr) in wrappers().items()}
