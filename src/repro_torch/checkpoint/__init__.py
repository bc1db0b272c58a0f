from .checkpoint import (
    AsyncCheckpointer,
    available_steps,
    prune,
    read_extras,
    restore,
    save,
)

__all__ = ["AsyncCheckpointer", "available_steps", "prune", "read_extras",
           "restore", "save"]
