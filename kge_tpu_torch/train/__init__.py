from kge_tpu_torch.train.job import Job, TrainingOrEvaluationJob
