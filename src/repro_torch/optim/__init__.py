"""Optimiser and gradient compression of the port: AdamW with global-norm
clipping (:mod:`.adamw`) and int8 error-feedback exchange
(:mod:`.compression`)."""

from .adamw import (adamw_init, adamw_init_blocks, adamw_update, clip_by_global_norm,
                    opt_state_shardings)

__all__ = ["adamw_init", "adamw_init_blocks", "adamw_update", "clip_by_global_norm",
           "opt_state_shardings"]
