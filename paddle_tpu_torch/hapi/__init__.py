"""paddle_tpu_torch.hapi — ``paddle.Model`` and its callbacks
(``paddle_tpu/hapi``)."""
from . import callbacks  # noqa: F401
from .model import Model  # noqa: F401
