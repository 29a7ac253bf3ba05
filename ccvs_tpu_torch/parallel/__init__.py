"""The parallel layer (counterpart of ``ccvs_tpu/parallel``): processes on a
``("data", "model")`` device mesh with explicit ``torch.distributed``
collectives in place of the JAX package's GSPMD shardings. Data parallelism
(:mod:`.mesh`) in every trainer, FSDP (:mod:`.fsdp`), tensor (:mod:`.tp`)
and sequence (:mod:`.sp`) parallelism of the GPT's training step, and a
GPipe pipeline of its blocks (:mod:`.pp`)."""

from ccvs_tpu_torch.parallel.fsdp import fsdp_param_specs, shard_fsdp
from ccvs_tpu_torch.parallel.mesh import (DataAxis, data_sharding, host_local_rows,
                                          init_distributed, make_mesh, put_batch, replicate,
                                          replicate_tree, shard_batch)

__all__ = ["make_mesh", "init_distributed", "data_sharding", "replicate", "replicate_tree",
           "shard_batch", "put_batch", "host_local_rows", "DataAxis", "fsdp_param_specs",
           "shard_fsdp"]
