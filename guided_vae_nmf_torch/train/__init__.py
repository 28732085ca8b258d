from .checkpoints import (
    best_checkpoint,
    load_classifier_meta,
    load_model,
    load_norm_stats,
    load_params,
)

__all__ = ["best_checkpoint", "load_classifier_meta", "load_model",
           "load_norm_stats", "load_params"]
