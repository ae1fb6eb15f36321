"""The port's micro-batching policy against the reference's.

``repro_torch.serving.batcher.MicroBatcher`` (plain Python, no tensors)
held to ``repro.serving.batcher.MicroBatcher``: the reference suite's
cases (``tests/test_serving.py``: flush on size and on the deadline,
FIFO order under any arrivals), and the two driven side by side through
the same calls, every answer and counter equal.
"""
from hypothesis import given, settings, strategies as st

from repro.serving.batcher import MicroBatcher as JaxMicroBatcher
from repro_torch.serving.batcher import MicroBatcher


def test_batcher_flush_on_size_and_deadline():
    mb = MicroBatcher(max_batch=4, max_wait=1.0)
    for i in range(3):
        mb.add(i, now=0.0)
    assert not mb.ready(now=0.5)
    assert mb.ready(now=1.0)          # deadline
    mb.add(3, now=1.0)
    assert mb.ready(now=1.0)          # size
    assert mb.flush() == [0, 1, 2, 3]
    assert len(mb) == 0


@settings(max_examples=40, deadline=None)
@given(st.lists(st.floats(0, 100), min_size=1, max_size=50),
       st.integers(1, 8))
def test_batcher_fifo_property(arrivals, max_batch):
    mb = MicroBatcher(max_batch=max_batch, max_wait=0.5)
    arrivals = sorted(arrivals)
    for i, t in enumerate(arrivals):
        mb.add(i, now=t)
    out = []
    while len(mb):
        out.extend(mb.flush())
    assert out == sorted(out)         # FIFO order preserved


@settings(max_examples=40, deadline=None)
@given(st.lists(st.floats(0, 10), min_size=1, max_size=40),
       st.integers(1, 6), st.floats(0, 2))
def test_batcher_answers_as_the_reference(arrivals, max_batch, max_wait):
    """Add, ask and flush in the same order on both: ``ready``,
    ``next_deadline``, the flushed items, ``len`` and the counters
    agree at every call."""
    ours = MicroBatcher(max_batch=max_batch, max_wait=max_wait)
    ref = JaxMicroBatcher(max_batch=max_batch, max_wait=max_wait)
    assert ours.next_deadline(0.0) is ref.next_deadline(0.0) is None
    assert ours.ready(0.0) is ref.ready(0.0) is False
    for i, t in enumerate(sorted(arrivals)):
        ours.add(i, now=t)
        ref.add(i, now=t)
        later = t + max_wait / 2
        assert ours.ready(later) == ref.ready(later)
        assert ours.next_deadline(later) == ref.next_deadline(later)
        if ref.ready(later):
            assert ours.flush() == ref.flush()
        assert len(ours) == len(ref)
    while len(ref):
        assert ours.flush() == ref.flush()
    assert (ours.flushes, ours.batched_items) == \
        (ref.flushes, ref.batched_items)
    assert len(ours) == 0
