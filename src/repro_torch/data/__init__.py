"""Synthetic task-mixture data (port of ``repro/data``)."""
from repro_torch.data.synthetic import (  # noqa: F401
    Batch,
    SyntheticTasks,
    mixture_iterator,
    retrieval_accuracy,
)
