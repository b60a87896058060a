"""Import trained LibKGE (PyTorch reference) checkpoints (counterpart of
``kge_tpu/utils/import_libkge.py``).

Converts a checkpoint written by the reference trainer
(kge/job/train.py:274-296: ``{"config": kge.Config, "model":
(state_dict, meta), "epoch", ...}``) into the params tree, model state
and config of a checkpoint that both packages load
(``KgeModel.create_from``): the weight mappings of ``kge_tpu``'s importer,
batch-norm running statistics included. The conversion is host work in
torch and numpy; the model it builds to learn the tree's shapes lives on
the CPU.

Usage:
    python -m kge_tpu_torch import-libkge libkge_checkpoint.pt \
        --file converted.pt [--dataset-folder data/fb15k-237]
"""

from __future__ import annotations

import sys
import types
from typing import Any, Dict, Optional

import numpy as np


# ------------------------------------------------------------------ loading


def _install_kge_stubs():
    """The reference pickles its ``kge.Config`` object into checkpoints;
    unpickling needs a class at ``kge.config.Config``. If the reference
    package is not importable (the normal case), install a minimal stub
    whose instances just carry the pickled ``__dict__``."""
    if "kge" in sys.modules:
        return
    try:
        import kge  # noqa: F401  (user may have the reference installed)
        return
    except ImportError:
        pass

    class _StubConfig:
        """Pickle target for kge.config.Config — attributes only."""

    kge_mod = types.ModuleType("kge")
    config_mod = types.ModuleType("kge.config")
    config_mod.Config = _StubConfig
    kge_mod.config = config_mod
    kge_mod.Config = _StubConfig
    sys.modules["kge"] = kge_mod
    sys.modules["kge.config"] = config_mod


def load_reference_checkpoint(path: str) -> Dict[str, Any]:
    """torch.load a LibKGE checkpoint on CPU without requiring the
    reference package to be installed."""
    import torch

    _install_kge_stubs()
    return torch.load(path, map_location="cpu", weights_only=False)


# ------------------------------------------------------------------ mapping


def _set(tree, key, value, pad_rows: bool = False):
    old = tree[key]
    value = np.asarray(value)
    if (pad_rows and value.ndim == 2 and len(old.shape) == 2
            and value.shape[1] == old.shape[1]
            and value.shape[0] < old.shape[0]):
        # vocab-padded table (LookupEmbedder.padded_vocab_size aligns to
        # the mesh model axis and the 8-row Mosaic tile): reference
        # tables are unpadded; pad rows are zero and never read
        value = np.concatenate(
            [value, np.zeros((old.shape[0] - value.shape[0],
                              value.shape[1]), value.dtype)],
            axis=0,
        )
    if tuple(old.shape) != tuple(value.shape):
        raise ValueError(
            f"shape mismatch importing {key}: ours {tuple(old.shape)} vs "
            f"reference {tuple(value.shape)}"
        )
    tree[key] = value.astype(np.asarray(old).dtype, copy=False)


def _conve_scorer(dst, state, sd, pre):
    _set(dst, "conv_w", sd[pre + "convolution.weight"])
    _set(dst, "conv_b", sd[pre + "convolution.bias"])
    _set(dst, "proj_w", sd[pre + "projection.weight"])
    _set(dst, "proj_b", sd[pre + "projection.bias"])
    # reference ConvE batch norms are affine=False (kge/model/conve.py:
    # 61-62) — only running statistics to carry over
    for bn in ("bn1", "bn2"):
        if pre + f"{bn}.running_mean" in sd and bn in state:
            _set(state[bn], "mean", sd[pre + f"{bn}.running_mean"])
            _set(state[bn], "var", sd[pre + f"{bn}.running_var"])


def _transformer_scorer(dst, sd, pre):
    _set(dst, "cls", sd[pre + "cls_emb"])
    _set(dst, "sub_type", sd[pre + "sub_type_emb"])
    _set(dst, "rel_type", sd[pre + "rel_type_emb"])
    for i, layer in enumerate(dst["layers"]):
        lp = f"{pre}encoder.layers.{i}."
        _set(layer, "qkv_w", sd[lp + "self_attn.in_proj_weight"])
        _set(layer, "qkv_b", sd[lp + "self_attn.in_proj_bias"])
        _set(layer, "out_w", sd[lp + "self_attn.out_proj.weight"])
        _set(layer, "out_b", sd[lp + "self_attn.out_proj.bias"])
        _set(layer, "lin1_w", sd[lp + "linear1.weight"])
        _set(layer, "lin1_b", sd[lp + "linear1.bias"])
        _set(layer, "lin2_w", sd[lp + "linear2.weight"])
        _set(layer, "lin2_b", sd[lp + "linear2.bias"])
        _set(layer, "ln1_scale", sd[lp + "norm1.weight"])
        _set(layer, "ln1_bias", sd[lp + "norm1.bias"])
        _set(layer, "ln2_scale", sd[lp + "norm2.weight"])
        _set(layer, "ln2_bias", sd[lp + "norm2.bias"])


def _rgnn_layer_bn_state(state, layer_name, sd, pre):
    key = f"{layer_name}_bn"
    if pre + "bn.running_mean" in sd and key in state:
        _set(state[key], "mean", sd[pre + "bn.running_mean"])
        _set(state[key], "var", sd[pre + "bn.running_var"])


def apply_reference_state_dict(model, params: Dict[str, Any],
                               state: Dict[str, Any],
                               sd: Dict[str, np.ndarray]) -> None:
    """Map a reference state_dict (numpy values) onto freshly initialized
    params/state trees of numpy arrays IN PLACE.

    ``model`` is the constructed KgeModel (used for type dispatch and
    encoder layer names); the mappings are ``kge_tpu``'s.
    """
    from kge_tpu_torch.models.rgnn.encoder import KgeRgnnModel
    from kge_tpu_torch.models.rgnn.layers import (
        MessagePassingLayer, RgcnLayer, WeightedGCNLayer)

    if isinstance(model, KgeRgnnModel):
        _set(params["entity_embedder"], "weights",
             sd["_encoder.entity_embedder._embeddings.weight"],
             pad_rows=True)
        _set(params["relation_embedder"], "weights",
             sd["_encoder.relation_embedder._embeddings.weight"],
             pad_rows=True)
        if "_scorer.convolution.weight" in sd:
            _conve_scorer(params["scorer"], state, sd, "_scorer.")
        layers = model.encoder.layers
        for i, (layer, lp) in enumerate(
                zip(layers, params["encoder"]["layers"])):
            pre = f"_encoder.rgnn.gnn_layers.{i}."
            if isinstance(layer, RgcnLayer):
                if "bias" in lp:
                    _set(lp, "bias", sd[pre + "bias"])
                if "blocks" in lp:
                    _set(lp, "blocks", sd[pre + "blocks"])
                    _set(lp, "block_self", sd[pre + "block_self"])
                elif "bases" in lp:
                    _set(lp, "bases", sd[pre + "bases"])
                    _set(lp, "comps", sd[pre + "comps"])
                else:
                    _set(lp, "weights", sd[pre + "weights"])
            elif isinstance(layer, WeightedGCNLayer):
                _set(lp, "weight", sd[pre + "weight"])
                _set(lp, "alpha", sd[pre + "alpha.weight"])
                if "bias" in lp:
                    _set(lp, "bias", sd[pre + "bias"])
                _set(lp, "bn_scale", sd[pre + "bn.weight"])
                _set(lp, "bn_bias", sd[pre + "bn.bias"])
                _rgnn_layer_bn_state(state, layer.name, sd, pre)
            elif isinstance(layer, MessagePassingLayer):
                if "w_rel" in lp:
                    _set(lp, "w_rel", sd[pre + "w_rel"])
                _set(lp, "loop_rel", sd[pre + "loop_rel"])
                if "bn_scale" in lp:
                    _set(lp, "bn_scale", sd[pre + "bn.weight"])
                    _set(lp, "bn_bias", sd[pre + "bn.bias"])
                    _rgnn_layer_bn_state(state, layer.name, sd, pre)
                if "bias" in lp:
                    _set(lp, "bias", sd[pre + "bias"])
                if "alpha" in lp:
                    _set(lp, "alpha", sd[pre + "alpha"])
                if "bases" in lp:  # per_relation_basis propagation
                    _set(lp, "bases", sd[pre + "bases"])
                    _set(lp, "comps", sd[pre + "comps"])
                    _set(lp, "w_loop", sd[pre + "loop_weight"])
                if "w_blocks" in lp:  # per_relation_block propagation
                    _set(lp, "w_blocks", sd[pre + "weights.w_blocks"])
                    _set(lp, "w_loop", sd[pre + "weights.w_loop"])
                if "basis_vectors" in lp:  # relation_basis decomposition
                    _set(lp, "basis_vectors", sd[pre + "basis_vectors"])
                    _set(lp, "relation_basis_weights",
                         sd[pre + "relation_basis_weights"])
                # per-mode head weights: our names are w_{mode}_h{h}
                # (mode may be EMPTY for the single propagations,
                # mirroring the reference's modes=[""]); reference names
                # are weights.w_{mode}_head_{h+1}. Strict: a missing
                # reference key raises instead of silently skipping.
                import re as _re

                hp = f"{pre}weights."
                for ours in sorted(lp):
                    m = _re.fullmatch(r"w_(.*)_h(\d+)", ours)
                    if not m:
                        continue
                    mode, h = m.group(1), int(m.group(2))
                    if mode == "att":
                        _set(lp, ours, sd[hp + f"w_att_{h + 1}"])
                    elif mode == "msgweight":
                        _set(lp, ours,
                             sd[hp + f"w_message_weight_head_{h + 1}"])
                    else:
                        _set(lp, ours, sd[hp + f"w_{mode}_head_{h + 1}"])
        return

    # non-GNN models: embedders first
    _set(params["entity_embedder"], "weights",
         sd["_entity_embedder._embeddings.weight"], pad_rows=True)
    rel = params["relation_embedder"]
    if "base" in rel:  # projection / Tucker3 relation embedder
        _set(rel["base"], "weights",
             sd["_relation_embedder.base_embedder._embeddings.weight"],
             pad_rows=True)
        _set(rel, "projection", sd["_relation_embedder.projection.weight"])
    else:
        _set(rel, "weights", sd["_relation_embedder._embeddings.weight"],
             pad_rows=True)
    if "_scorer.cls_emb" in sd:  # (reciprocal-wrapped) Transformer
        _transformer_scorer(params["scorer"], sd, "_scorer.")
    elif "_scorer.convolution.weight" in sd:  # (reciprocal-wrapped) ConvE
        _conve_scorer(params["scorer"], state, sd, "_scorer.")


# ------------------------------------------------------------------ convert


def convert_reference_checkpoint(ckpt: Dict[str, Any],
                                 dataset_folder: Optional[str] = None
                                 ) -> Dict[str, Any]:
    """Build a checkpoint dict in ``kge_tpu``'s layout from a loaded
    reference checkpoint. If ``dataset_folder`` is omitted, entity/relation counts
    are inferred from the embedding-table shapes (the produced
    checkpoint then behaves like a packaged model without id maps)."""
    import torch

    from kge_tpu_torch.config import Config
    from kge_tpu_torch.dataset import Dataset
    from kge_tpu_torch.models import KgeModel

    ref_cfg = ckpt["config"]
    options = ref_cfg.options if hasattr(ref_cfg, "options") else ref_cfg
    flat = Config.flatten(options)

    config = Config()
    config.folder = None
    model_key = flat.get("model")
    if not model_key:
        raise ValueError("reference checkpoint carries no model key")
    config.set("model", model_key)
    config._import(model_key)
    for imp in options.get("import", []) or []:
        config._import(imp)
    # the reference's job.device ("cuda") is the reference run's, not ours
    drop = {"job.device", "model", "import", "modules"}
    config.load_options(
        {k: v for k, v in flat.items() if k not in drop}, create=True
    )

    sd_t, _meta = ckpt["model"]
    sd = {k: np.asarray(v.detach().cpu().numpy())
          for k, v in sd_t.items()}

    try:
        class_name = config.get(f"{model_key}.class_name")
    except KeyError:
        class_name = ""
    is_rgnn = class_name in ("RGCN", "WGCN", "CompGCN", "RAGAT")
    if is_rgnn and dataset_folder is None:
        # must be checked BEFORE model construction: the encoder loads
        # the training graph in its constructor
        raise ValueError(
            "importing an R-GNN checkpoint requires --dataset-folder "
            "(the encoder needs the training graph)"
        )
    if dataset_folder is not None:
        dataset = Dataset.create(config, dataset_folder,
                                 preload_data=False)
    else:
        ent_key = ("_encoder.entity_embedder._embeddings.weight"
                   if "_encoder.entity_embedder._embeddings.weight" in sd
                   else "_entity_embedder._embeddings.weight")
        rel_key = ("_encoder.relation_embedder._embeddings.weight"
                   if "_encoder.relation_embedder._embeddings.weight" in sd
                   else ("_relation_embedder.base_embedder"
                         "._embeddings.weight"
                         if "_relation_embedder.base_embedder"
                            "._embeddings.weight" in sd
                         else "_relation_embedder._embeddings.weight"))
        num_entities = int(sd[ent_key].shape[0])
        rel_rows = int(sd[rel_key].shape[0])
        # reciprocal wrappers and the R-GNN presets double the relation
        # vocabulary (inverse relations)
        doubled = (model_key == "reciprocal_relations_model" or is_rgnn)
        num_relations = rel_rows // 2 if doubled else rel_rows
        config.set("dataset.num_entities", num_entities)
        config.set("dataset.num_relations", num_relations)
        dataset = Dataset(config, folder=None)

    model = KgeModel.create(config, dataset, device=torch.device("cpu"),
                            generator=torch.Generator().manual_seed(0))
    params, state = model.params(), model.state()
    apply_reference_state_dict(model, params, state, sd)

    out: Dict[str, Any] = {
        "type": "import",
        "epoch": int(ckpt.get("epoch", 0) or 0),
        "job_id": ckpt.get("job_id"),
        "imported_from": "libkge",
        "valid_trace": ckpt.get("valid_trace", []),
    }
    out["model"] = {"params": params, "state": state}
    config.save_to(out)
    dataset.save_to(out)
    return out


def import_reference_checkpoint(path: str,
                                dataset_folder: Optional[str] = None
                                ) -> Dict[str, Any]:
    """load + convert in one call (see module docstring)."""
    return convert_reference_checkpoint(
        load_reference_checkpoint(path), dataset_folder=dataset_folder
    )
