from kge_tpu_torch.models.embedder.lookup import LookupEmbedder
from kge_tpu_torch.models.embedder.projection import (
    ProjectionEmbedder,
    Tucker3RelationEmbedder,
)
