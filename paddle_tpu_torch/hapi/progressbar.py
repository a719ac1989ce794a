"""Progress bar (``paddle_tpu/hapi/progressbar.py``; reference
python/paddle/hapi/progressbar.py). Plain Python, the JAX package's own."""
from __future__ import annotations

import sys
import time

import numpy as np


class ProgressBar:
    def __init__(self, num=None, width=30, verbose=1, start=True, file=sys.stdout):
        self._num = num
        self._width = width
        self._verbose = verbose
        self.file = file
        self._values = {}
        self._seen = 0
        # monotonic: the ms-a-step figure must not go negative or jump
        self._start = time.monotonic()

    def update(self, current_num, values=None):
        now = time.monotonic()
        values = values or []
        for k, v in values:
            self._values[k] = v
        if self._verbose != 1:
            return
        msg = f"step {current_num}"
        if self._num:
            msg += f"/{self._num}"
        for k, v in self._values.items():
            if isinstance(v, (float, np.floating)):
                msg += f" - {k}: {v:.4f}"
            elif isinstance(v, (list, np.ndarray)):
                msg += f" - {k}: " + " ".join(f"{x:.4f}" for x in np.ravel(v)[:3])
            else:
                msg += f" - {k}: {v}"
        elapsed = now - self._start
        msg += f" - {1000*elapsed/max(current_num,1):.0f}ms/step"
        self.file.write("\r" + msg)
        if self._num and current_num >= self._num:
            self.file.write("\n")
        self.file.flush()
