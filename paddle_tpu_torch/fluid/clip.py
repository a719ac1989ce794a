"""fluid.clip (reference fluid/clip.py): the 1.x names of the clips."""
from ..nn import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue  # noqa: F401

GradientClipByValue = ClipGradByValue
GradientClipByNorm = ClipGradByNorm
GradientClipByGlobalNorm = ClipGradByGlobalNorm
