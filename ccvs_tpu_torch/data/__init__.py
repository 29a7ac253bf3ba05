"""Input pipeline of the port: its own copy of ``ccvs_tpu/data`` (datasets,
clip indexing, elastic views, the prefetching loader), numpy on the host."""

from ccvs_tpu_torch.data.base import BaseVideoDataset, create_dataset, group_collate
from ccvs_tpu_torch.data.loader import FoldCycler, PrefetchLoader

__all__ = ["BaseVideoDataset", "create_dataset", "group_collate", "PrefetchLoader", "FoldCycler"]
