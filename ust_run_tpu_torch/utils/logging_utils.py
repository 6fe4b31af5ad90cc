"""Metric writer: tensorboardX when available, JSONL fallback.

The reference writes scalars through tensorboardX.SummaryWriter
(train.py:401, 859-870). The same scalar names are kept; when
tensorboardX is absent the scalars land in `<logdir>/scalars.jsonl`.
"""

import json
import os


class MetricWriter:
    def __init__(self, logdir):
        os.makedirs(logdir, exist_ok=True)
        self._tb = None
        try:
            from tensorboardX import SummaryWriter
            self._tb = SummaryWriter(logdir)
        except Exception:
            self._f = open(os.path.join(logdir, "scalars.jsonl"), "a")

    def add_scalar(self, tag, value, step):
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))
        else:
            self._f.write(json.dumps({"tag": tag, "value": float(value),
                                      "step": int(step)}) + "\n")

    def flush(self):
        if self._tb is not None:
            self._tb.flush()
        else:
            self._f.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
        else:
            self._f.close()
