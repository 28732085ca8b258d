"""Misc utilities (reference python/utils.py:5-22).

Counterpart of `guided_vae_nmf_tpu/utils.py`. `open_file` and `get_key`
are copies; `count_parameters` is `models.nets.count_parameters`;
:func:`device_warmup` starts the card before a heavy entry point.
"""

import subprocess
import sys

import torch

from .models.nets import count_parameters  # noqa: F401  (re-exported)


def open_file(path):
    """Open a file / folder with the platform handler (reference
    utils.py:10-17)."""
    if sys.platform == "win32":
        import os

        os.startfile(path)
    else:
        opener = "open" if sys.platform == "darwin" else "xdg-open"
        subprocess.call([opener, path])


def get_key(val, my_dict):
    """Reverse dictionary lookup (reference utils.py:19-22)."""
    for key, value in my_dict.items():
        if val == value:
            return key
    return "key doesn't exist"


def device_warmup(device):
    """Create the CUDA context on `device`, run one tiny op there and wait
    for it, so that a card that cannot run stops the caller before any
    real work (`pipeline.enhance_files`, `train.fit` call it first). Any
    error propagates: unlike the JAX package's TPU workaround, nothing is
    swallowed. Does nothing on a CPU device."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    torch.cuda.init()
    torch.ones(8, device=device).add_(1)
    torch.cuda.synchronize(device)
