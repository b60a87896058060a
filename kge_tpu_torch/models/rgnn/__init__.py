from kge_tpu_torch.models.rgnn.encoder import (
    CompGCN,
    KgeRgnnModel,
    RAGAT,
    RGCN,
    Rgnn,
    RgnnEncoder,
    WGCN,
    build_graph_buffers,
)
from kge_tpu_torch.models.rgnn.layers import (
    MessagePassingLayer,
    RgcnLayer,
    WeightedGCNLayer,
)
