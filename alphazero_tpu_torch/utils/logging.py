"""Structured metrics logging.

Counterpart of ``alphazero_tpu/utils/logging.py``: every coach iteration
emits one record, printed to the Python logger and appended as JSONL
beside the checkpoints.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional

logger = logging.getLogger("alphazero_tpu_torch")


class MetricsLogger:
    def __init__(self, out_dir: Optional[str] = None, filename: str = "metrics.jsonl"):
        self.path = None
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            self.path = os.path.join(out_dir, filename)

    def log(self, record: dict) -> None:
        record = dict(record)
        record.setdefault("ts", time.time())
        logger.info(
            "iter=%s %s",
            record.get("iteration", "?"),
            " ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in record.items()
                if k not in ("ts", "iteration")
            ),
        )
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(record) + "\n")
