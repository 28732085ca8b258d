"""The M2 enhancement sweep shared by `evaluate_M2_ibm` and
`evaluate_M2_vad` (their JAX counterparts differ only in the target, the
guidance dimension and the output name)."""

import os
import sys
import time

from ..config import PathsConfig, apply_overrides
from ..data import speech_list
from ..pipeline import enhance_files
from ._common import (device, engine_config, flag, load_model,
                      load_norm_stats, no_data_parallel)


def run(argv, target):
    argv = sys.argv[1:] if argv is None else argv
    paths, rest = apply_overrides(PathsConfig(), argv)
    cfg, rest = engine_config(rest)
    model_path = flag(rest, "model", paths.models_dir)
    classifier_path = flag(rest, "classifier")
    classif_type = flag(rest, "classif_type", "dnn")
    noise_model = flag(rest, "noise_model", "nmf")
    profile = flag(rest, "profile", None)
    soft_labels = flag(rest, "soft_labels", "0") in ("1", "true")
    output = flag(rest, "output", paths.models_dir
                  + f"M2_{target}_{classif_type}_enhanced/")
    batch_size = flag(rest, "batch_size", 16, int)
    skip_existing = flag(rest, "skip_existing", "0") in ("1", "true")
    no_data_parallel(rest)
    dev = device(rest)

    dgm = load_model(model_path, kind="dgm",
                     y_dim=1 if target == "vad" else 513, device=dev)
    classifier, mean, std = None, None, None
    features, dnn_threshold = "power", 0.5
    if classif_type == "dnn":
        if classifier_path is None:
            raise SystemExit("--classifier <ckpt-or-dir> is required with "
                             "--classif_type dnn")
        classifier = load_model(classifier_path, kind="classifier",
                                device=dev)
        cdir = (classifier_path if os.path.isdir(classifier_path)
                else os.path.dirname(classifier_path))
        mean, std = load_norm_stats(cdir)
        # the shipped classifier's protocol (classifier_meta.json: input
        # features and calibrated threshold); flags may override
        from ..train import load_classifier_meta

        cmeta = load_classifier_meta(cdir)
        features = flag(rest, "features", cmeta["features"])
        dnn_threshold = flag(rest, "dnn_threshold", cmeta["threshold"],
                             float)

    files = speech_list(paths.input_speech_dir, "test")
    t0 = time.perf_counter()
    res = enhance_files(files, paths.processed_wav_dir, output, dgm,
                        model_type="m2", classif_type=classif_type,
                        target=target, classifier=classifier, mean=mean,
                        std=std, cfg=cfg, batch_size=batch_size,
                        verbose=True, noise_model=noise_model,
                        soft_guidance=soft_labels,
                        skip_existing=skip_existing, profile=profile,
                        features=features, dnn_threshold=dnn_threshold,
                        device=dev)
    skipped = f", {res.n_skipped} skipped" if res.n_skipped else ""
    print(f"Finished in {time.perf_counter() - t0:.1f} seconds "
          f"({res.n_processed} utterances{skipped})")
    return res
