"""M1 + MCEM enhancement sweep over the test set (reference
scripts/evaluate_M1.py), one padded batch a bucket on the GPU.

Usage: python -m guided_vae_nmf_torch.scripts.evaluate_M1
       --model <ckpt-or-dir> [--algorithm mcem|peem|hybrid]
       [--dataset_size subset] [--data_root data] [--niter 100]
       [--batch_size 16] [--output <dir>] [--noise_model nmf|spp|spp2|hybrid]
       [--profile <name>] [--skip_existing 0] [--data_parallel 0]
       [--device cuda|cpu]
"""

import sys
import time

from ..config import PathsConfig, apply_overrides
from ..data import speech_list
from ..pipeline import enhance_files
from ._common import (data_parallel, device, engine_config, flag,
                      load_model)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    paths, rest = apply_overrides(PathsConfig(), argv)
    cfg, rest = engine_config(rest)
    model_path = flag(rest, "model", paths.models_dir)
    output = flag(rest, "output", paths.models_dir + "M1_enhanced/")
    batch_size = flag(rest, "batch_size", 16, int)
    noise_model = flag(rest, "noise_model", "nmf")
    profile = flag(rest, "profile", None)
    skip_existing = flag(rest, "skip_existing", "0") in ("1", "true")
    mesh = data_parallel(rest)
    dev = device(rest)

    vae = load_model(model_path, kind="vae", device=dev)
    files = speech_list(paths.input_speech_dir, "test")
    t0 = time.perf_counter()
    res = enhance_files(files, paths.processed_wav_dir, output, vae,
                        model_type="m1", cfg=cfg, batch_size=batch_size,
                        verbose=True, noise_model=noise_model,
                        skip_existing=skip_existing, profile=profile,
                        mesh=mesh, device=dev)
    skipped = f", {res.n_skipped} skipped" if res.n_skipped else ""
    print(f"Finished in {time.perf_counter() - t0:.1f} seconds "
          f"({res.n_processed} utterances{skipped})")
    return res


if __name__ == "__main__":
    main()
