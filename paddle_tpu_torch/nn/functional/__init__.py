"""paddle_tpu_torch.nn.functional — the functional ops the ported layers
and a training loop call (a subset of ``paddle_tpu.nn.functional``)."""
from . import activation, common, conv, loss, norm, pooling  # noqa: F401
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403

__all__ = (activation.__all__ + common.__all__ + conv.__all__ + loss.__all__
           + norm.__all__ + pooling.__all__)
