"""Datasets: the synthetic MNIST digits (a copy of ``repro.data.mnist``)
and the synthetic LM token stream (a copy of ``repro.data.tokens``)."""
