"""Hand-written CUDA kernels (csrc/) with their wrappers and plain versions.

No module here imports a compiler or builds anything when it is imported:
kernels are compiled at first launch (`build.load`).
"""
