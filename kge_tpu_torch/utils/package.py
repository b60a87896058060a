"""``package``: a training checkpoint stripped to a distributable model
file (counterpart of ``kge_tpu/utils/package.py``; reference:
kge/util/package.py): the model's params and state, the config, the
epoch and its validation trace, and the entity and relation id maps, so
``KgeModel.create_from`` and ``lookup_embedder.pretrain`` use it with the
dataset folder gone. The config is written as a plain options dict with
``kge_tpu``'s module names (``Config.save_to``), so either package loads
the file."""

from __future__ import annotations

import os
from typing import Optional

from kge_tpu_torch.config import Config
from kge_tpu_torch.dataset import Dataset
from kge_tpu_torch.utils.io import load_checkpoint, save_checkpoint


def package_model(checkpoint_file: str, output_file: Optional[str] = None
                  ) -> str:
    checkpoint = load_checkpoint(checkpoint_file)
    if checkpoint["type"] != "train":
        raise ValueError("can only package train checkpoints")
    packaged = {
        "type": "package",
        "model": checkpoint["model"],
        "epoch": checkpoint.get("epoch"),
        "job_id": checkpoint.get("job_id"),
        "valid_trace": checkpoint.get("valid_trace"),
    }
    config = Config.create_from(checkpoint)
    config.save_to(packaged)
    dataset = Dataset.create_from(checkpoint, config, preload_data=False)
    dataset.entity_ids()
    dataset.relation_ids()
    dataset.save_to(packaged, ["entity_ids", "relation_ids"])
    if output_file is None:
        output_file = os.path.join(os.path.dirname(checkpoint_file),
                                   "model.pt")
    save_checkpoint(output_file, packaged)
    print(f"Packaged model written to {output_file}")
    return output_file
