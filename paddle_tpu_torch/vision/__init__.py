"""paddle_tpu_torch.vision (``paddle_tpu/vision``): the models only.
``transforms``, ``datasets`` and ``ops`` are not ported yet."""
from . import models  # noqa: F401
from .models import *  # noqa: F401,F403

__all__ = ["models"] + models.__all__
