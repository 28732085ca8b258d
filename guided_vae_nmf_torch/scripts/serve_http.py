"""Deployable HTTP enhancement endpoint (wav in -> enhanced wav out) on the
GPU: the flagship configuration (M2 + DNN classifier, SPP noise model)
from the shipped pretrained artifacts behind the dynamic-batching
EnhancementService, and the online route POST /v1/enhance_stream (a
StreamingM2Enhancer a connection, or with --pooled_streams 1 one pool
ticked for every connection). See guided_vae_nmf_torch/http_serving.py
for the API.

Usage: python -m guided_vae_nmf_torch.scripts.serve_http [--host 0.0.0.0]
       [--port 8571] [--models artifacts/pretrained] [--niter 100]
       [--noise_model spp] [--noise_gain 0] [--noise_gain_bands 1]
       [--soft_labels 0] [--fast 0] [--wait_ms 20] [--warmup 0]
       [--stream 1] [--chunk_frames 8] [--stream_residual 0]
       [--pooled_streams 0] [--max_streams 8] [--tick_ms 5]
       [--profile <name>] [--data_parallel 0] [--device cuda|cpu]

`--data_parallel 1` shards the request batches and the pooled streams over
every visible card (over the one `--device` otherwise).
"""

from ..http_serving import main

if __name__ == "__main__":
    main()
