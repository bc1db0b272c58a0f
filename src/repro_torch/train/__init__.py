from .loop import HDPConfig, HDPTrainer, Pod, train_single
from .step import (
    make_decode_step,
    make_grain_grad_fn,
    make_prefill_step,
    make_train_step,
)
from .train_state import TrainState, init_train_state

__all__ = ["HDPConfig", "HDPTrainer", "Pod", "train_single",
           "make_grain_grad_fn", "make_train_step",
           "make_prefill_step", "make_decode_step", "TrainState",
           "init_train_state"]
