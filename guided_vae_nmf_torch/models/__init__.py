from .convert import module_from_params
from .nets import (
    DGM,
    VAE,
    Classifier,
    Decoder,
    Encoder,
    Linear,
    classifier_apply,
    classifier_features,
    decoder_apply,
    dgm_apply,
    dgm_sample,
    encoder_apply,
    linear_apply,
    reparametrize,
    vae_apply,
    vae_sample,
)

__all__ = [
    "DGM", "VAE", "Classifier", "Decoder", "Encoder", "Linear",
    "classifier_apply", "classifier_features", "decoder_apply", "dgm_apply",
    "dgm_sample", "encoder_apply", "linear_apply", "module_from_params",
    "reparametrize", "vae_apply", "vae_sample",
]
