"""The port's LLM prompt workloads draw the reference's prompts.

``repro_torch.serving.loadgen`` keeps its own copy of the reference's
workload generators (numpy only); from the same seed each must return
the same prompts, output lengths, bursts and tenants, token for token.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.serving import loadgen as jlg  # noqa: E402
from repro_torch.serving import loadgen as tlg  # noqa: E402

SEEDS = (0, 1, 7)
GENERATORS = {
    "shared_prefix": dict(num_requests=7, prefix_len=10, suffix_len=5,
                          vocab_size=97, num_prefixes=3),
    "mixed_length": dict(num_requests=9, vocab_size=97, max_len=40),
    "bursty_mixed": dict(num_bursts=3, burst_size=4, vocab_size=97,
                         max_len=30),
    "windowed_long_context": dict(num_requests=5, vocab_size=97, window=8,
                                  prompt_len=20, max_new=12),
    "repetitive": dict(num_requests=6, vocab_size=97, prompt_len=14,
                       max_new=10),
    "multi_tenant": dict(num_tenants=3, num_bursts=2, burst_size=5,
                         prefix_len=8, vocab_size=97),
}


def _same(a, b):
    """Dataclass fields equal, arrays and nested lists of arrays exactly."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_workload_draws_the_reference_prompts(name, seed):
    fn = f"{name}_workload"
    got = getattr(tlg, fn)(seed=seed, **GENERATORS[name])
    want = getattr(jlg, fn)(seed=seed, **GENERATORS[name])
    assert type(got).__name__ == type(want).__name__
    for f in dataclasses.fields(want):
        _same(getattr(got, f.name), getattr(want, f.name))
    assert got.total_prompt_tokens == want.total_prompt_tokens
    assert len(got.prompts) > 0
