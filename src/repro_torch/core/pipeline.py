"""The Stratus end-to-end pipeline object: train -> evaluate -> checkpoint
-> deploy -> serve (paper Fig. 1), the port of ``repro.core.pipeline``.

``StratusPipeline`` holds the CNN's parameters on ``device`` (the card
unless the caller asks for ``"cpu"``), trains them with a Spark/Elephas
strategy (``core.strategies``) over the synthetic digits, evaluates them
on the synthetic test and canvas sets, wraps them in a predict function
and mounts that behind ``StratusApp`` (NGINX balancer -> Kafka broker ->
consumer -> CouchDB).  Weights come from a seed, from training, from
``bridge.params_from_jax``, or from a checkpoint that either package
saved: assign the restored tree's ``"params"`` to ``pipeline.params``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.mnist_cnn import CONFIG as MNIST_CNN
from repro_torch.configs.mnist_cnn import CNNConfig
from repro_torch.core.strategies import make_strategy
from repro_torch.core.trainer import Trainer, worker_batches
from repro_torch.data import mnist
from repro_torch.models.cnn import cnn_forward, cnn_loss, cnn_schema
from repro_torch.models.module import init_params
from repro_torch.optim import adam
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
    """train -> checkpoint -> deploy -> serve; ``params`` is a plain
    attribute."""

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
        self._loss_fn = lambda p, b: cnn_loss(p, cfg, b["x"], b["y"])

    # ------------------------------------------------------------ train
    def train(self, train_n: int = 12_000, rounds: int = 40,
              steps_per_round: int = 2, log=lambda s: None) -> Dict[str, Any]:
        """Paper Sec. II-C: batch 64, distributed over ``num_workers``
        (5 Spark workers there).  Effective epochs scale with ``rounds``.
        ``seconds`` covers the device's work: the trainer reads each
        round's metrics back as floats."""
        cfg = self.cfg
        x, y = mnist.make_split(train_n, self.seed)
        strategy = make_strategy(self.strategy_name, adam(1e-3),
                                 self.num_workers)
        trainer = Trainer(strategy, self._loss_fn, ckpt=self.ckpt,
                          ckpt_every=0, log_every=max(rounds // 4, 1))
        it = worker_batches(x, y, self.num_workers, steps_per_round,
                            cfg.batch_size, self.seed, device=self.device)
        t0 = time.perf_counter()
        self.params, _, history = trainer.fit(self.params, it, rounds, log=log)
        train_time = time.perf_counter() - t0
        if self.ckpt:
            self.ckpt.save(rounds, {"params": self.params})
        return {"seconds": train_time, "history": history}

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
