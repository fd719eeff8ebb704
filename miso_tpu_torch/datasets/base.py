"""Dataset protocol (port of ``miso_tpu/datasets/base.py``).

Host-side numpy sampling, as in the JAX package: one "epoch" is one freshly
sampled mega-batch, and ``sample(rng) -> dict`` returns one flat dict of
fixed-shape numpy arrays.  The trainer moves each batch to the model's
device.  ``SubmapDataset`` waits for the SLAM slice.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


class Dataset:
    def sample(self, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        raise NotImplementedError
