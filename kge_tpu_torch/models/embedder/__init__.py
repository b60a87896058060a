from kge_tpu_torch.models.embedder.lookup import LookupEmbedder
