from .adamw import AdamWConfig, adamw_update, global_norm, init_opt_state, lr_at
from .grad_compress import compressed_bytes, ef_compress_tree, init_residuals

__all__ = ["AdamWConfig", "adamw_update", "global_norm", "init_opt_state",
           "lr_at", "compressed_bytes", "ef_compress_tree", "init_residuals"]
