"""paddle_tpu_torch.vision (``paddle_tpu/vision``): the models, the
detection ops, the host-side transforms and the datasets."""
from . import datasets  # noqa: F401
from . import models  # noqa: F401
from . import ops  # noqa: F401
from . import transforms  # noqa: F401
from .datasets import MNIST, Cifar10, Cifar100, FashionMNIST  # noqa: F401
from .models import *  # noqa: F401,F403

__all__ = (["models", "ops", "transforms", "datasets", "MNIST",
            "FashionMNIST", "Cifar10", "Cifar100", "set_image_backend",
            "get_image_backend"] + models.__all__)


def set_image_backend(backend):
    """Images are numpy arrays whatever the backend: a no-op, as in the
    JAX package."""


def get_image_backend():
    return "numpy"
