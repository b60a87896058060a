from kge_tpu_torch.models.api import (
    Ctx,
    KgeBase,
    KgeEmbedder,
    KgeModel,
    RelationalScorer,
)
from kge_tpu_torch.models.factorization import (
    CP,
    CPScorer,
    ComplEx,
    ComplExScorer,
    DistMult,
    DistMultScorer,
    RelationalTucker3,
    Rescal,
    RescalScorer,
    SimplE,
    SimplEScorer,
)
from kge_tpu_torch.models.translation import (
    RotatE,
    RotatEScorer,
    TransE,
    TransEScorer,
    TransH,
    TransHScorer,
)
from kge_tpu_torch.models.conve import ConvE, ConvEScorer
from kge_tpu_torch.models.transformer import Transformer, TransformerScorer
from kge_tpu_torch.models.reciprocal import ReciprocalRelationsModel
from kge_tpu_torch.models.embedder import (
    LookupEmbedder,
    ProjectionEmbedder,
    Tucker3RelationEmbedder,
)
from kge_tpu_torch.models.rgnn import (
    CompGCN,
    KgeRgnnModel,
    RAGAT,
    RGCN,
    RgnnEncoder,
    WGCN,
)
