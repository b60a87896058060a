"""Multi-device training over ``torch.distributed`` (counterpart of
``kge_tpu/parallel/``): the (data, model) mesh with one process per
device (``mesh``), process bootstrap and host-level agreement
(``distributed``), and the collectives with autograd that the sharded
tables and the data-parallel loss are built from (``collectives``)."""
