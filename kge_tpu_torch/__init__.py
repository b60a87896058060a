"""kge_tpu_torch: the PyTorch/CUDA port of kge_tpu.

A second package beside ``kge_tpu`` (the JAX reference), held against it
on the same inputs. It imports nothing of ``kge_tpu``, ``jax`` or
``optax``, reads ``kge_tpu``'s configs and checkpoints, and writes
checkpoints ``kge_tpu`` reads. It trains (``python -m kge_tpu_torch
start``), evaluates (``test``) and searches the hyperparameters of every
scorer and R-GNN encoder of ``kge_tpu``, in float32 or bf16, and has its
other verbs (``package``, ``import-libkge``, ``dump``), with hand-written
CUDA kernels for the rank count, the fused shared-negative loss and the
row-sparse updates (``csrc/``).
"""

from kge_tpu_torch.config import Config, Configurable
from kge_tpu_torch.dataset import Dataset

__version__ = "0.1.0"

__all__ = ["Config", "Configurable", "Dataset"]
