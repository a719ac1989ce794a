"""The legacy reader decorator ``paddle.batch`` (``paddle_tpu/batch.py``;
reference python/paddle/batch.py:18), for pre-DataLoader ingestion code:
an item-level reader becomes a batch-level reader (lists of items)."""
from __future__ import annotations

__all__ = ["batch"]


def batch(reader, batch_size, drop_last=False):
    """Wrap an item-level reader into a batch-level reader."""
    if batch_size <= 0:
        raise ValueError("batch_size should be a positive integer, got %r"
                         % (batch_size,))

    def batch_reader():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batch_reader
