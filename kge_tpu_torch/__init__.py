"""kge_tpu_torch: the PyTorch/CUDA port of kge_tpu.

A second package beside ``kge_tpu`` (the JAX reference), held against it
on the same inputs. It imports nothing of ``kge_tpu``, ``jax`` or
``optax``, reads ``kge_tpu``'s configs and checkpoints, and writes
checkpoints ``kge_tpu`` reads. So far it evaluates ComplEx checkpoints
(``python -m kge_tpu_torch test <folder>``) through the hand-written CUDA
rank-count kernel (``csrc/rank_count.cu``).
"""

from kge_tpu_torch.config import Config, Configurable
from kge_tpu_torch.dataset import Dataset

__version__ = "0.1.0"

__all__ = ["Config", "Configurable", "Dataset"]
