"""paddle_tpu_torch.nn.functional — ``paddle_tpu.nn.functional``'s
functions: activations, the common functions, convolutions and their
transposes, pooling, the norms, the losses, the extension functions and
the sequence functions."""
from . import (activation, common, conv, extension, loss,  # noqa: F401
               norm, pooling, sequence)
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .extension import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .sequence import *  # noqa: F401,F403

__all__ = (activation.__all__ + common.__all__ + conv.__all__
           + extension.__all__ + loss.__all__ + norm.__all__
           + pooling.__all__ + sequence.__all__)
