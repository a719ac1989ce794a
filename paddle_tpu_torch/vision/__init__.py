"""paddle_tpu_torch.vision (``paddle_tpu/vision``): the models only.
``transforms``, ``datasets`` and ``ops`` are not ported yet."""
from . import models  # noqa: F401
from .models import LeNet, ResNet, resnet18, resnet50  # noqa: F401

__all__ = ["models", "LeNet", "ResNet", "resnet18", "resnet50"]
