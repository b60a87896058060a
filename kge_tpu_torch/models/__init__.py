from kge_tpu_torch.models.api import (
    Ctx,
    KgeBase,
    KgeEmbedder,
    KgeModel,
    RelationalScorer,
)
from kge_tpu_torch.models.factorization import ComplEx, ComplExScorer
from kge_tpu_torch.models.embedder import LookupEmbedder
