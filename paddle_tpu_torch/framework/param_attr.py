"""ParamAttr — parameter attribute spec (own copy of
``paddle_tpu/framework/param_attr.py``'s ``ParamAttr``)."""
from __future__ import annotations

__all__ = ["ParamAttr", "WeightNormParamAttr"]


class ParamAttr:
    def __init__(
        self,
        name=None,
        initializer=None,
        learning_rate=1.0,
        regularizer=None,
        trainable=True,
        do_model_average=True,
        need_clip=True,
    ):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """Normalize: None -> default, False -> no parameter, str -> named,
        Initializer -> wrap, ParamAttr -> itself."""
        if attr is None:
            return ParamAttr()
        if attr is False:
            return False
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        return ParamAttr(initializer=attr)


class WeightNormParamAttr(ParamAttr):
    """reference WeightNormParamAttr (fluid/param_attr.py:216): asks for
    the weight-norm reparameterization g * v / ||v||. As in the JAX
    package, that is served by the layer hook ``nn.utils.weight_norm``:
    making a parameter with this attribute raises and says so, rather
    than training it unnormalized."""

    def __init__(self, dim=None, name=None, initializer=None,
                 learning_rate=1.0, regularizer=None, trainable=True,
                 do_model_average=False, need_clip=True):
        super().__init__(name=name, initializer=initializer,
                         learning_rate=learning_rate,
                         regularizer=regularizer, trainable=trainable,
                         do_model_average=do_model_average,
                         need_clip=need_clip)
        self.weight_norm_dim = dim
