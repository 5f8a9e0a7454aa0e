"""Training: config, the train and eval steps, the epoch loop, metrics,
checkpoints, logging.  Counterpart of `satmvs_tpu/train/` (one device)."""

from .config import Config  # noqa: F401
from .loop import (  # noqa: F401
    TrainState,
    create_model,
    create_model_and_state,
    fit,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
