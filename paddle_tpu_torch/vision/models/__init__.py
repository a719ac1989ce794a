"""paddle_tpu_torch.vision.models (``paddle_tpu/vision/models``): LeNet
and the ResNet family. AlexNet, VGG, MobileNet and ResNeXt are not
ported yet.

The models build the same layers under the same names as the JAX
package's, so ``model.set_state_dict(numpy_state)`` carries a JAX
model's weights and batch-norm buffers across by name (numpy f32 arrays
under its ``state_dict()`` names, before ``amp.decorate``)."""
from .lenet import LeNet  # noqa: F401
from .resnet import (BasicBlock, BottleneckBlock, ResNet,  # noqa: F401
                     resnet18, resnet34, resnet50, resnet101, resnet152,
                     wide_resnet50_2, wide_resnet101_2)

__all__ = ["LeNet", "BasicBlock", "BottleneckBlock", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "wide_resnet50_2", "wide_resnet101_2"]
