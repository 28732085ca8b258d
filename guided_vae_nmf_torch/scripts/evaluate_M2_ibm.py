"""M2 + IBM-classifier enhancement sweep (reference
scripts/evaluate_M2_ibm.py): the classifier (or oracle / SPP "timo")
predicts per-bin labels, then batched label-conditioned MCEM on the GPU.

Usage: python -m guided_vae_nmf_torch.scripts.evaluate_M2_ibm
       --model <ckpt-or-dir> [--classifier <ckpt-or-dir>]
       [--classif_type dnn|oracle|timo] [--algorithm mcem|peem|hybrid]
       [--dataset_size subset] [--data_root data] [--niter 100]
       [--batch_size 16] [--output <dir>] [--noise_model nmf|spp|spp2|hybrid]
       [--profile reference|real-noise|impulse-noise] [--soft_labels 0]
       [--skip_existing 0] [--features power] [--dnn_threshold 0.5]
       [--device cuda|cpu]
"""

from ._evaluate_m2 import run


def main(argv=None):
    return run(argv, "ibm")


if __name__ == "__main__":
    main()
