"""The Stratus pipeline object, serving half: evaluate -> deploy -> serve
(paper Fig. 1), the port of ``repro.core.pipeline``.

``StratusPipeline`` holds the CNN's parameters on ``device`` (the card
unless the caller asks for ``"cpu"``), evaluates them on the synthetic
test and canvas sets, wraps them in a predict function and mounts that
behind ``StratusApp`` (NGINX balancer -> Kafka broker -> consumer ->
CouchDB).  Weights come from a seed, from ``bridge.params_from_jax``,
or from a checkpoint that either package saved: assign the restored
tree's ``"params"`` to ``pipeline.params``.  Training (the strategies,
the trainer and the optimizers) is not ported yet (ROADMAP Queue 1
item 9).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.mnist_cnn import CONFIG as MNIST_CNN
from repro_torch.configs.mnist_cnn import CNNConfig
from repro_torch.data import mnist
from repro_torch.models.cnn import cnn_forward, cnn_schema
from repro_torch.models.module import init_params
from repro_torch.serving.server import AppConfig, StratusApp
from repro_torch.serving.sim import Clock


@dataclasses.dataclass
class PipelineReport:
    train_seconds: float
    rounds: int
    train_loss: float
    test_accuracy: float
    canvas_accuracy: float
    per_digit_canvas: Dict[int, float]


class StratusPipeline:
    """checkpoint -> deploy -> serve; ``params`` is a plain attribute."""

    def __init__(self, cfg: CNNConfig = MNIST_CNN, *, strategy: str = "sync",
                 num_workers: int = 5, ckpt_dir: Optional[str] = None,
                 seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.strategy_name = strategy
        self.num_workers = num_workers
        self.seed = seed
        self.device = torch.device(device)
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self.params = init_params(cnn_schema(cfg), seed, cfg.dtype,
                                  self.device)

    def train(self, *args, **kwargs):
        raise NotImplementedError(
            "StratusPipeline.train is not ported to repro_torch yet "
            "(ROADMAP Queue 1 item 9: strategies, trainer, optimizers); "
            "restore a checkpoint or bridge trained weights into .params")

    def _images(self, images: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(
            np.ascontiguousarray(images, dtype=np.float32)).to(self.device)

    # ------------------------------------------------------------ evaluate
    def evaluate(self, test_n: int = 2_000, canvas_n: int = 1_000
                 ) -> Dict[str, object]:
        """Accuracy on ``test_n`` synthetic test digits and ``canvas_n``
        canvas digits (the paper's distribution shift), one forward pass
        over each whole set."""
        def predictions(images):
            with torch.inference_mode():
                logits = cnn_forward(self.params, self.cfg,
                                     self._images(images))
            return torch.argmax(logits, -1).cpu().numpy()

        xt, yt = mnist.make_split(test_n, self.seed + 100)
        pt = predictions(xt)
        xc, yc = mnist.canvas_digits(canvas_n, self.seed + 200)
        pc = predictions(xc)
        per_digit = {d: float(np.mean(pc[yc == d] == d)) for d in range(10)}
        return {
            "test_accuracy": float(np.mean(pt == yt)),
            "canvas_accuracy": float(np.mean(pc == yc)),
            "per_digit_canvas": per_digit,
        }

    # ------------------------------------------------------------ deploy
    def predict_fn(self) -> Callable[[np.ndarray], np.ndarray]:
        """(B, 28, 28, 1) images -> (B, 10) float32 probabilities, numpy.
        The result comes back through ``.cpu()``, which waits for the
        device, so a caller's wall clock covers the device's work.  Warms
        the consumer's batch shapes (1 and 32), which on the card also
        builds the conv kernel at first use."""
        params = self.params
        cfg = self.cfg

        def predict(images: np.ndarray) -> np.ndarray:
            with torch.inference_mode():
                logits = cnn_forward(params, cfg, self._images(images))
                return torch.softmax(logits, -1).cpu().numpy()

        for b in (1, 32):
            predict(np.zeros((b, 28, 28, 1), np.float32))
        return predict

    def deploy(self, clock: Clock, app_cfg: AppConfig = None,
               seed: int = 0) -> StratusApp:
        return StratusApp(clock, self.predict_fn(),
                          app_cfg or AppConfig(), seed=seed)
