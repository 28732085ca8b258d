"""The demos (counterparts of the JAX package's `examples/`), each a module
with `main(argv)`:

    python -m guided_vae_nmf_torch.examples.demo_enhancement
    python -m guided_vae_nmf_torch.examples.demo_serving
    python -m guided_vae_nmf_torch.examples.demo_streaming
    python -m guided_vae_nmf_torch.examples.demo_streaming_http
    python -m guided_vae_nmf_torch.examples.notebook_tours

Each reads its utterances from `--data_root`, a directory in the
reference's subset layout (`raw/`, `processed/`, `pickle/`), where the JAX
demos hard-code the reference's `data/subset`; runs on `--device` (the
card unless the caller passes `cpu`); and writes its files under `--out`
where the JAX demo writes files. They print the JAX demos' lines.
"""
