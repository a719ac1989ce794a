"""paddle_tpu_torch.vision.models (``paddle_tpu/vision/models``): LeNet,
AlexNet, VGG, the ResNet family, MobileNet V1 / V2 and ResNeXt.

The models build the same layers under the same names as the JAX
package's, so ``model.set_state_dict(numpy_state)`` carries a JAX
model's weights and batch-norm buffers across by name (numpy f32 arrays
under its ``state_dict()`` names, before ``amp.decorate``)."""
from .alexnet import AlexNet, alexnet  # noqa: F401
from .lenet import LeNet  # noqa: F401
from .mobilenet import (MobileNetV1, MobileNetV2, mobilenet_v1,  # noqa: F401
                        mobilenet_v2)
from .resnet import (BasicBlock, BottleneckBlock, ResNet,  # noqa: F401
                     resnet18, resnet34, resnet50, resnet101, resnet152,
                     wide_resnet50_2, wide_resnet101_2)
from .resnext import (ResNeXt, resnext50_32x4d, resnext50_64x4d,  # noqa: F401
                      resnext101_32x4d, resnext101_64x4d, resnext152_32x4d,
                      resnext152_64x4d)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401

__all__ = ["LeNet", "AlexNet", "alexnet", "VGG", "vgg11", "vgg13", "vgg16",
           "vgg19", "BasicBlock", "BottleneckBlock", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "wide_resnet50_2", "wide_resnet101_2", "MobileNetV1",
           "MobileNetV2", "mobilenet_v1", "mobilenet_v2", "ResNeXt",
           "resnext50_32x4d", "resnext50_64x4d", "resnext101_32x4d",
           "resnext101_64x4d", "resnext152_32x4d", "resnext152_64x4d"]
