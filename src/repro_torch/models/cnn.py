"""The paper's model (Sec. II-C): Keras-default MNIST CNN in PyTorch.

Conv2D(32, 3x3, relu) -> MaxPool(2) -> Flatten -> Dense(128, relu) ->
Dense(10), the port of ``repro.models.cnn``.  Parameters are a flat dict
of tensors with the reference's names, shapes and scale rules, so
``bridge.params_from_jax`` and the checkpoint store carry weights across
both ways.

Everything stays NHWC, as in the reference: the flatten runs in
(h, w, c) order, which ``dense1_w`` is trained against (an NCHW layout
would permute the 5,408 features).  The convolution always goes through
``ops.conv2d``: the CUDA kernel for a tensor on the card, the plain
version for one on the CPU.  The reference's ``use_kernel`` switch has
no counterpart.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.mnist_cnn import CNNConfig
from repro_torch.kernels import ops
from repro_torch.models.module import ParamSpec


def cnn_schema(cfg: CNNConfig):
    k, cin, cout = cfg.conv_kernel, cfg.in_channels, cfg.conv_channels
    side = (cfg.image_size - cfg.conv_kernel + 1) // cfg.pool
    flat = side * side * cout
    return {
        "conv_w": ParamSpec((k, k, cin, cout), (None,) * 4, scale_dim=-2),
        "conv_b": ParamSpec((cout,), (None,), init="zeros"),
        "dense1_w": ParamSpec((flat, cfg.hidden), (None, None), scale_dim=-2),
        "dense1_b": ParamSpec((cfg.hidden,), (None,), init="zeros"),
        "dense2_w": ParamSpec((cfg.hidden, cfg.num_classes), (None, None),
                              scale_dim=-2),
        "dense2_b": ParamSpec((cfg.num_classes,), (None,), init="zeros"),
    }


def conv2d_valid(x, w):
    """NHWC x HWIO valid convolution, stride 1."""
    return ops.conv2d(x, w)


def cnn_forward(params: Dict, cfg: CNNConfig, images):
    """images (B, 28, 28, 1) in [0,1] -> logits (B, 10)."""
    x = conv2d_valid(images, params["conv_w"])
    x = torch.relu(x + params["conv_b"])
    b, h, w, c = x.shape
    p = cfg.pool
    x = x[:, : h - h % p, : w - w % p, :]
    x = x.reshape(b, h // p, p, w // p, p, c).amax(dim=(2, 4))
    x = x.reshape(b, -1)
    x = torch.relu(x @ params["dense1_w"] + params["dense1_b"])
    return x @ params["dense2_w"] + params["dense2_b"]


def cnn_loss(params, cfg: CNNConfig, images, labels):
    """-> (mean cross-entropy, {"loss", "accuracy"}); labels (B,) int."""
    logits = cnn_forward(params, cfg, images)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    loss = torch.mean(logz - gold)
    acc = torch.mean((torch.argmax(logits, -1) == labels).float())
    return loss, {"loss": loss, "accuracy": acc}
