"""Build the CUDA kernels ahead of the traffic (counterpart of the JAX
package's scripts/warm_cache.py, which fills a persistent XLA compile
cache).

The port compiles no programs per shape: its only first-use cost that
outlives a process is the kernels' build (`csrc/*.cu` with nvcc, cached by
source hash in the build directory, `build/gvnmf_torch/` or
`$GVNMF_TORCH_BUILD_DIR`). This script builds every stale source and
loads every library; later processes find them there. It launches no
kernel. On the CPU there is nothing to build.

Usage: python -m guided_vae_nmf_torch.scripts.warm_cache [--device cuda|cpu]

The JAX script's shape-grid flags are accepted and ignored, since the
kernels take any shape: [--buckets 384,512,640] [--batch_size 32]
[--labels oracle,dnn] [--noise_models nmf] [--fast 1] [--y_dim 513]
[--serving 1] [--stream 1].
"""

import sys
import time

from ._common import device


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    dev = device(argv)

    from .. import _build

    n_done = 0
    if dev.type == "cuda":
        t0 = time.perf_counter()
        _build.build_all()
        n_done = len(list(_build.CSRC.glob("*.cu")))
        print(f"kernels built ({time.perf_counter() - t0:.1f}s)", flush=True)
    print(f"warmed {n_done} programs into {_build.build_dir()}")
    return n_done


if __name__ == "__main__":
    main()
