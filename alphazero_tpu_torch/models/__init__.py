from alphazero_tpu_torch.models.convert import (
    convert_az_resnet,
    convert_mlp,
    mlp_state_dict,
    order_free_mlp_variables,
    random_az_resnet_variables,
    random_mlp_variables,
)
from alphazero_tpu_torch.models.nets import (
    AZResNet,
    FoldedAZResNet,
    MLPKernelWeights,
    MLPNet,
    UniformModel,
    make_apply_fn,
    make_uniform_model,
    pack_mlp_weights,
)

__all__ = [
    "UniformModel",
    "make_uniform_model",
    "AZResNet",
    "FoldedAZResNet",
    "MLPNet",
    "MLPKernelWeights",
    "pack_mlp_weights",
    "make_apply_fn",
    "convert_az_resnet",
    "random_az_resnet_variables",
    "convert_mlp",
    "mlp_state_dict",
    "order_free_mlp_variables",
    "random_mlp_variables",
]
