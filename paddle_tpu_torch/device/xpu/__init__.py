"""``paddle.device.xpu`` (counterpart of ``paddle_tpu/device/xpu``): XPU
hardware is not part of the CUDA build."""

__all__ = ["synchronize"]


def synchronize(device=None):
    raise NotImplementedError("XPU devices are not part of the CUDA build")
