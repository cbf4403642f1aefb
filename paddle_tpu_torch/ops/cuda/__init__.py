"""The port's hand-written CUDA kernels, each with its plain PyTorch
version and a launch count. Sources live in ``paddle_tpu_torch/csrc/``.
"""
