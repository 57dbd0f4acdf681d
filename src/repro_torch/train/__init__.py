"""Training: the optimizer, the three trainers and checkpoints (port of
``repro/train``)."""
from repro_torch.train import checkpoint, optimizer  # noqa: F401
from repro_torch.train.train_loop import (  # noqa: F401
    ContinuedTrainer,
    PretrainTrainer,
    RouterTrainer,
    chunked_cross_entropy,
    cross_entropy,
)
