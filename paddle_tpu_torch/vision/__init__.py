"""``paddle.vision`` of the port: the model zoo (``vision.models``), the
detection ops (``vision.ops``) and the image backend setting with
``image_load``. The reference's datasets and transforms wait for
``ROADMAP.md`` queue A item 8."""
from . import models, ops
from .models import *  # noqa: F401,F403
from .models import __all__ as _models_all

__all__ = ["models", "ops", "set_image_backend", "get_image_backend",
           "image_load", *_models_all]

_image_backend = "pil"


def set_image_backend(backend):
    """The backend ``image_load`` reads with: "pil", "cv2", "tensor" or
    "numpy"."""
    global _image_backend
    if backend not in ("pil", "cv2", "tensor", "numpy"):
        raise ValueError(f"invalid backend {backend!r}")
    _image_backend = backend


def get_image_backend():
    return _image_backend


def image_load(path, backend=None):
    """Read an image file with ``backend`` (default: the one set): a PIL
    image with "pil" (numpy when Pillow is missing); otherwise a numpy
    array (``np.load`` of a ``.npy`` file, else the file's bytes). "cv2"
    raises: OpenCV is not a dependency."""
    backend = backend or _image_backend
    if backend == "pil":
        try:
            from PIL import Image

            return Image.open(path)
        except ImportError:
            backend = "numpy"
    if backend == "cv2":
        raise RuntimeError("cv2 is not available in this environment")
    import numpy as np

    return np.load(path) if str(path).endswith(".npy") else np.fromfile(
        path, dtype="uint8")
