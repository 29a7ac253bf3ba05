"""What the latent-stage trainers share with the autoencoder trainer
(counterpart of ``ccvs_tpu/train/ae_trainer.py:308-320``): an endless
loader and the move of a numpy batch to the trainer's device. The
autoencoder trainer itself comes with its own slice."""

import numpy as np
import torch


def cycle_loader(loader):
    while True:
        yield from loader


def to_device(batch, device):
    """Host batch (numpy arrays or tensors) -> tensors on ``device``."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray)
                else torch.as_tensor(v)).to(device)
            for k, v in batch.items()}
