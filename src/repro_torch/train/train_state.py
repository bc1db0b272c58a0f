"""TrainState: params + AdamW state as one pytree.

Port of ``repro/train/train_state.py``.  A dataclass whose fields flatten
in order (params, then opt), as the reference registers it with
``jax.tree_util`` (``repro_torch.tree``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from ..optim.adamw import init_opt_state


@dataclasses.dataclass(frozen=True)
class TrainState:
    params: Any
    opt: dict

    @property
    def step(self):
        return self.opt["step"]


def init_train_state(params) -> TrainState:
    return TrainState(params=params, opt=init_opt_state(params))
