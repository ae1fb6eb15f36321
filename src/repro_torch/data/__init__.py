"""Datasets: the synthetic MNIST digits (a copy of ``repro.data.mnist``)."""
