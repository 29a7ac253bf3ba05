"""Scalar logging to ``metrics.jsonl`` (counterpart of the scalar part of
``ccvs_tpu/utils/logging.py``): one JSON line ``{"t", "step", name: value}``
per scalar. Image and video logging are not on the trainers' path yet."""

import json
import os
import time

import torch


class Logger:
    def __init__(self, log_path: str):
        os.makedirs(log_path, exist_ok=True)
        self.jsonl = open(os.path.join(log_path, "metrics.jsonl"), "a")

    def log_scalar(self, name, value, step):
        """``t`` is stamped when the value reaches the host: reading a device
        tensor waits for the step that made it."""
        if value is None:
            return
        v = float(value.item() if torch.is_tensor(value) else value)
        self.jsonl.write(json.dumps({"t": time.time(), "step": int(step), name: v}) + "\n")

    def log_scalars(self, metrics: dict, step, prefix=""):
        for k, v in metrics.items():
            self.log_scalar(prefix + k, v, step)
        if self.jsonl:
            self.jsonl.flush()

    def close(self):
        if self.jsonl:
            self.jsonl.close()
            self.jsonl = None
