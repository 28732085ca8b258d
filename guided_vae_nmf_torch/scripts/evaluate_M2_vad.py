"""M2 + VAD-guided enhancement sweep (reference scripts/evaluate_M2_vad.py):
frame-level VAD labels (y_dim=1) condition the MCEM; the dnn / oracle /
timo label sources and the ones / zeros ablations
(evaluate_M2_vad.py:133-137).

Usage: python -m guided_vae_nmf_torch.scripts.evaluate_M2_vad
       --model <ckpt-or-dir> [--classifier <ckpt-or-dir>]
       [--classif_type dnn|oracle|timo|ones|zeros]
       [--algorithm mcem|peem|hybrid] [--dataset_size subset]
       [--data_root data] [--niter 100] [--batch_size 16] [--output <dir>]
       [--noise_model nmf|spp|spp2|hybrid] [--profile <name>]
       [--soft_labels 0] [--skip_existing 0] [--device cuda|cpu]
"""

from ._evaluate_m2 import run


def main(argv=None):
    return run(argv, "vad")


if __name__ == "__main__":
    main()
