from .checkpoints import (
    best_checkpoint,
    checkpoint_name,
    load_classifier_meta,
    load_model,
    load_norm_stats,
    load_params,
    load_resume_state,
    save_classifier_meta,
    save_params,
    save_resume_state,
)
from .trainer import (
    TrainConfig,
    calibrate_threshold,
    classifier_loss,
    fit,
    m1_loss,
    m2_loss,
    make_eval_step,
    make_optimizer,
    make_train_step,
    train_classifier,
    train_m1,
    train_m2,
    train_wiener,
    wiener_loss,
)

__all__ = [
    "TrainConfig", "best_checkpoint", "calibrate_threshold",
    "checkpoint_name", "classifier_loss", "fit", "load_classifier_meta",
    "load_model", "load_norm_stats", "load_params", "load_resume_state",
    "m1_loss", "m2_loss", "make_eval_step", "make_optimizer",
    "make_train_step", "save_classifier_meta", "save_params",
    "save_resume_state", "train_classifier", "train_m1", "train_m2",
    "train_wiener", "wiener_loss",
]
