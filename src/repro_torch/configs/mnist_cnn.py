"""The paper's own model: Keras-style MNIST CNN (Sec. II-C).

The port's copy of ``repro.configs.mnist_cnn``.

Conv2D -> MaxPooling2D -> Flatten -> Dense -> Dense; batch 64, 10 epochs,
trained data-parallel over 5 Spark workers in the paper.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str = "mnist-cnn"
    arch_type: str = "cnn"
    source: str = "Stratus paper Sec. II-C (Keras default MNIST CNN)"
    image_size: int = 28
    in_channels: int = 1
    conv_channels: int = 32
    conv_kernel: int = 3
    pool: int = 2
    hidden: int = 128
    num_classes: int = 10
    batch_size: int = 64          # paper hyperparameter
    epochs: int = 10              # paper hyperparameter
    dtype: str = "float32"


CONFIG = CNNConfig()
