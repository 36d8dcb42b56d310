from alphazero_tpu_torch.models.convert import (
    convert_az_resnet,
    random_az_resnet_variables,
)
from alphazero_tpu_torch.models.nets import (
    AZResNet,
    FoldedAZResNet,
    UniformModel,
    make_apply_fn,
    make_uniform_model,
)

__all__ = [
    "UniformModel",
    "make_uniform_model",
    "AZResNet",
    "FoldedAZResNet",
    "make_apply_fn",
    "convert_az_resnet",
    "random_az_resnet_variables",
]
