"""Experiment loggers: CSV, TensorBoard events, optional wandb.

Port of humangaussian_tpu/utils/loggers.py: small host-side objects the
train loop fans out to (`MultiLogger`). `CSVLogger` and `MultiLogger` are
plain Python. `TensorBoardLogger` needs an event writer (`tensorboardX`,
else `torch.utils.tensorboard`, which needs the `tensorboard` package)
and raises ImportError without one; the launcher then leaves it out.
`WandbLogger` is opt-in and disables itself, with one printed line, when
`wandb` is missing or cannot start.
"""
from __future__ import annotations

import csv
import os
from typing import Sequence

import numpy as np
import torch


def _scalar(v) -> float:
    return float(v.detach().cpu()) if isinstance(v, torch.Tensor) else float(v)


def _image(img) -> np.ndarray:
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    return np.asarray(img)


class TensorBoardLogger:
    """Scalar and image event writer."""

    def __init__(self, log_dir: str):
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            from torch.utils.tensorboard import SummaryWriter

        os.makedirs(log_dir, exist_ok=True)
        self.writer = SummaryWriter(log_dir)

    def log_scalars(self, step: int, scalars: dict):
        for k, v in scalars.items():
            try:
                self.writer.add_scalar(k, _scalar(v), step)
            except (TypeError, ValueError):
                pass

    def log_image(self, step: int, tag: str, img):
        arr = _image(img)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
        self.writer.add_image(tag, arr, step, dataformats="HWC")

    def close(self):
        self.writer.close()


class CSVLogger:
    """Append-only metrics CSV; the first row fixes the columns."""

    def __init__(self, path: str):
        self.path = path
        self._keys: list[str] | None = None
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log_scalars(self, step: int, scalars: dict):
        row = {"step": step,
               **{k: _scalar(v) for k, v in scalars.items()
                  if np.ndim(v) == 0}}
        new_file = self._keys is None and not os.path.exists(self.path)
        if self._keys is None:
            self._keys = list(row)
        with open(self.path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._keys, extrasaction="ignore")
            if new_file:
                w.writeheader()
            w.writerow(row)

    def log_image(self, step: int, tag: str, img):
        pass

    def close(self):
        pass


class WandbLogger:
    """Optional wandb logging; disabled with one printed line when the
    package is missing or its run cannot start."""

    def __init__(self, project: str, name: str, config: dict | None = None):
        try:
            import wandb

            self._run = wandb.init(project=project, name=name,
                                   config=config or {})
            self._wandb = wandb
        except Exception as e:  # module missing or offline init failure
            print(f"[loggers] wandb disabled: {e}")
            self._run = None
            self._wandb = None

    def log_scalars(self, step: int, scalars: dict):
        if self._run is not None:
            self._wandb.log({k: _scalar(v) for k, v in scalars.items()},
                            step=step)

    def log_image(self, step: int, tag: str, img):
        if self._run is not None:
            self._wandb.log({tag: self._wandb.Image(_image(img))}, step=step)

    def close(self):
        if self._run is not None:
            self._run.finish()


class MultiLogger:
    """Fan-out to a set of loggers."""

    def __init__(self, loggers: Sequence):
        self.loggers = list(loggers)

    def log_scalars(self, step: int, scalars: dict):
        for lg in self.loggers:
            lg.log_scalars(step, scalars)

    def log_image(self, step: int, tag: str, img):
        for lg in self.loggers:
            lg.log_image(step, tag, img)

    def close(self):
        for lg in self.loggers:
            lg.close()
