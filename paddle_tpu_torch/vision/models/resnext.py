"""ResNeXt (``paddle_tpu/vision/models/resnext.py``): the ResNet
bottleneck trunk with grouped 3×3 convs (``groups`` = cardinality, 4
channels a group at the first stage); 152 layers are [3, 8, 36, 3]."""
from __future__ import annotations

from .mobilenet import _no_pretrained
from .resnet import BottleneckBlock, ResNet

__all__ = ["ResNeXt", "resnext50_32x4d", "resnext50_64x4d",
           "resnext101_32x4d", "resnext101_64x4d", "resnext152_32x4d",
           "resnext152_64x4d"]


class ResNeXt(ResNet):
    def __init__(self, depth=50, cardinality=32, num_classes=1000,
                 with_pool=True):
        self.cardinality = cardinality
        super().__init__(BottleneckBlock, depth, width=4,
                         num_classes=num_classes, with_pool=with_pool,
                         groups=cardinality)


def _resnext(depth, cardinality, pretrained, **kwargs):
    _no_pretrained(pretrained)
    return ResNeXt(depth=depth, cardinality=cardinality, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    return _resnext(50, 32, pretrained, **kwargs)


def resnext50_64x4d(pretrained=False, **kwargs):
    return _resnext(50, 64, pretrained, **kwargs)


def resnext101_32x4d(pretrained=False, **kwargs):
    return _resnext(101, 32, pretrained, **kwargs)


def resnext101_64x4d(pretrained=False, **kwargs):
    return _resnext(101, 64, pretrained, **kwargs)


def resnext152_32x4d(pretrained=False, **kwargs):
    return _resnext(152, 32, pretrained, **kwargs)


def resnext152_64x4d(pretrained=False, **kwargs):
    return _resnext(152, 64, pretrained, **kwargs)
