from kge_tpu_torch.search.search import SearchJob
from kge_tpu_torch.search.auto import AutoSearchJob
from kge_tpu_torch.search.manual import GridSearchJob, ManualSearchJob
from kge_tpu_torch.search.ax import AxSearchJob
