"""Parameters from the reference package, as the port's tensors.

``params_from_jax`` takes the reference model's parameter tree with numpy
leaves (``jax.tree.map(np.asarray, Model(cfg).init(key))``) and returns
the same tree — ``embed`` (with ``positions`` for learned positions),
``stack/periods/slot{j}`` with the leading ``n_periods`` axis,
``stack/rem/layer{j}``, or whisper's ``encdec`` (``encoder/layer{i}``,
``enc_pos``, ``enc_norm``, ``decoder/layer{i}``), paligemma's
``projector``, ``final_norm`` — with torch tensors on ``device``.  The digit CNN's tree is flat: ``conv_w`` (3,3,1,32)
HWIO, ``conv_b``, ``dense1_w`` (5408,128) in the reference's (h, w, c)
flatten order, ``dense1_b``, ``dense2_w``, ``dense2_b``
(``jax.tree.map(np.asarray, init_params(cnn_schema(cfg), key,
"float32"))``, or a trained ``StratusPipeline.params``).  bfloat16 leaves (numpy's ``bfloat16`` extension
type) keep their bits and become ``torch.bfloat16``.  This module needs
neither JAX nor the reference package; the tests that call it do.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaf(a, device) -> torch.Tensor:
    a = np.array(a, copy=True)        # writable, contiguous, owned
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree, device="cuda"):
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return _leaf(tree, device)
