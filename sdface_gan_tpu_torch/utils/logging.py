"""Training metrics: one JSON line per ``log`` call and a printed line at a
cadence (the part of ``sdface_gan_tpu/utils/logging.py`` the loops use)."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict


class MetricsLogger:
    def __init__(self, out_dir: str, name: str = "train", print_every: int = 10):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, f"{name}_metrics.jsonl")
        self._file = open(self.path, "a")
        self.print_every = print_every
        self._last_print = 0.0

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        """Append ``{"step", "time", **metrics}`` (values as floats)."""
        values = {k: float(v) for k, v in metrics.items()}
        self._file.write(json.dumps({"step": step, "time": time.time(), **values}) + "\n")
        self._file.flush()
        if self.print_every and step % self.print_every == 0:
            now = time.time()
            dt = now - self._last_print if self._last_print else 0.0
            self._last_print = now
            desc = " ".join(f"{k}={v:.4f}" for k, v in values.items())
            print(f"[{step}] {desc} ({dt:.1f}s/{self.print_every}it)", flush=True)

    def close(self) -> None:
        self._file.close()
