"""Tensor-parallel serving on ``torch.distributed`` (the port of
``repro/distributed/``'s serving half): process groups and the launcher
(``group``), the weight layout and the model's reduce points
(``sharding``) and the decode caches' head sharding (``pool_sharding``).
"""
from repro_torch.distributed.group import (  # noqa: F401
    BACKENDS, TPDivergence, TPGroup, init_tp, launch)
from repro_torch.distributed.sharding import (  # noqa: F401
    check_tp_supported, shard_params_tp, tensor_parallel, tp_config,
    tp_reduce)
