"""Experiments of the port: counterparts of the repository's
``experiments/`` scripts that run on the card.

  - :mod:`alphazero_tpu_torch.experiments.int8_fused_tower` — the whole
    Connect-Four ResNet tower (11 convs, int8 activations and weights) in
    one hand-written kernel, against the library's int8 and bf16 towers
"""
