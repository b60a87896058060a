from kge_tpu_torch.train.job import Job, TrainingOrEvaluationJob
from kge_tpu_torch.train.train import TrainingJob
from kge_tpu_torch.train.train_1vsall import TrainingJob1vsAll
from kge_tpu_torch.train.train_kvsall import TrainingJobKvsAll
from kge_tpu_torch.train.train_negative_sampling import (
    TrainingJobNegativeSampling,
)
from kge_tpu_torch.train.loss import KgeLoss
from kge_tpu_torch.train.optimizer import KgeLRScheduler, KgeOptimizer
from kge_tpu_torch.train.sampler import KgeSampler
