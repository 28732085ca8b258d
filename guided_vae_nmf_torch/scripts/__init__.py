"""The evaluation, serving, diagnostic and streaming scripts of the port,
each run as `python -m guided_vae_nmf_torch.scripts.<name>` with the flags
of the JAX package's `scripts/<name>.py` plus `--device` (the GPU unless
named; `--device cpu` runs the kernels' plain versions)."""
