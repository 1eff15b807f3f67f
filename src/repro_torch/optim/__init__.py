"""Optimizer and gradient compression (counterpart of
``src/repro/optim``)."""
from .adamw import (OptConfig, apply_gradients, cosine_schedule, global_norm,
                    init_opt_state)
from .compress import (CompressionConfig, compress_gradients,
                       compressed_bytes, init_error_state)

__all__ = ["OptConfig", "apply_gradients", "cosine_schedule", "global_norm",
           "init_opt_state", "CompressionConfig", "compress_gradients",
           "compressed_bytes", "init_error_state"]
