"""Streaming-HTTP client demo (counterpart of the JAX package's
examples/demo_streaming_http.py): stand up the enhancement endpoint
in-process, stream a test mixture to POST /v1/enhance_stream in 100 ms
PCM16 chunks over one chunked-transfer connection (full duplex: enhanced
audio is read back while the input is still being sent), and report the
end-to-end stream latency and SI-SDR improvement.

The server side is what `python -m guided_vae_nmf_torch.http_serving`
deploys; any client that can speak chunked HTTP (curl, sox | curl, a
browser fetch with a ReadableStream body) gets the same online path.

Usage: python -m guided_vae_nmf_torch.examples.demo_streaming_http
       [--chunk_frames 4] [--context 24] [--block_iters 6] [--e_steps 4]
       [--data_root data/subset] [--device cuda|cpu]
       [--artifacts artifacts/pretrained]
       (the defaults are the flagship latency / quality point of the JAX
       package's VALIDATION.md; smaller values run faster on the CPU)
"""

import os
import socket
import sys
import time

import numpy as np

from ..data import read_wav, speech_list
from ._args import device, parser

FS = 16000
CHUNK = FS // 10  # 100 ms


def _pcm16(x):
    return np.clip(np.round(np.asarray(x) * 32768.0),
                   -32768, 32767).astype("<i2").tobytes()


def main(argv=None):
    from ..http_serving import EnhancementHTTPServer
    from ..mcem import MCEMConfig
    from ..serving import EnhancementService, ServeConfig
    from ..streaming import StreamingM2Enhancer
    from ..train import load_model, load_norm_stats

    ap = parser(__doc__)
    for name, default in (("chunk_frames", 4), ("context", 24),
                          ("block_iters", 6), ("e_steps", 4)):
        ap.add_argument(f"--{name}", type=int, default=default)
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    dev = device(args)

    m2 = load_model(os.path.join(args.artifacts, "M2_ibm"), kind="dgm",
                    device=dev)
    cdir = os.path.join(args.artifacts, "classifier_ibm")
    cls = load_model(cdir, kind="classifier", device=dev)
    mean, std = load_norm_stats(cdir)

    svc = EnhancementService(m2, classifier=cls, mean=mean, std=std,
                             cfg=MCEMConfig(niter=25),
                             serve=ServeConfig(label_mode="dnn",
                                               noise_model="spp"),
                             device=dev)
    srv = EnhancementHTTPServer(
        svc, port=0,
        stream_factory=lambda: StreamingM2Enhancer(
            m2, classifier=cls, mean=mean, std=std,
            chunk_frames=args.chunk_frames, context_frames=args.context,
            block_iters=args.block_iters, e_steps=args.e_steps,
            device=dev),
    ).start()

    # the noisy test mixture and its clean / noise tracks for scoring
    # (speech_list paths already start with CSR-1-WSJ-0/)
    proc = os.path.join(args.data_root, "processed")
    utt = speech_list(os.path.join(args.data_root, "raw") + "/",
                      "test")[0].replace(".wav", "")
    x, _ = read_wav(f"{proc}/{utt}_x.wav")
    s, _ = read_wav(f"{proc}/{utt}_s.wav")
    n, _ = read_wav(f"{proc}/{utt}_n.wav")
    pcm = _pcm16(x)

    sock = socket.create_connection(("127.0.0.1", srv.port), timeout=120)
    sock.sendall(b"POST /v1/enhance_stream HTTP/1.1\r\nHost: demo\r\n"
                 b"Content-Type: audio/L16\r\n"
                 b"Transfer-Encoding: chunked\r\n\r\n")
    sock.setblocking(False)

    got = b""
    first_out = None
    t0 = time.perf_counter()
    for off in range(0, len(pcm), 2 * CHUNK):
        blk = pcm[off:off + 2 * CHUNK]
        sock.setblocking(True)
        sock.sendall(f"{len(blk):x}\r\n".encode() + blk + b"\r\n")
        sock.setblocking(False)
        try:                                  # drain whatever came back
            while True:
                b = sock.recv(1 << 16)
                if not b:
                    break
                got += b
                # first enhanced chunk = first chunk-size line after the
                # response headers (they are sent before any audio)
                if first_out is None and b"\r\n\r\n" in got:
                    body = got.split(b"\r\n\r\n", 1)[1]
                    if body.split(b"\r\n", 1)[0]:
                        first_out = time.perf_counter() - t0
        except BlockingIOError:
            pass
        time.sleep(CHUNK / FS)                # real-time pacing
    sock.setblocking(True)
    sock.sendall(b"0\r\n\r\n")
    while b"0\r\n\r\n" not in got:
        b = sock.recv(1 << 16)
        if not b:
            break
        got += b
    wall = time.perf_counter() - t0
    sock.close()
    srv.close()
    svc.close()

    # de-chunk the response payload
    head, tail = got.split(b"\r\n\r\n", 1)
    payload = b""
    while b"\r\n" in tail:
        line, tail = tail.split(b"\r\n", 1)
        k = int(line or b"0", 16)
        if k == 0:
            break
        payload, tail = payload + tail[:k], tail[k + 2:]
    y = np.frombuffer(payload, "<i2").astype(np.float64) / 32768.0

    sdr_in = energy_sdr(x, s, n)
    sdr_out = energy_sdr(y, s, n)
    first = ("%.2fs" % first_out) if first_out is not None else \
        "after input end"
    print(f"streamed {len(x) / FS:.1f}s of audio in {wall:.1f}s "
          f"({len(x) / FS / wall:.2f}x realtime pacing), first enhanced "
          f"bytes after {first}")
    print(f"SI-SDR: mixture {sdr_in:+.2f} dB -> enhanced {sdr_out:+.2f} dB")
    return {"status": head.split(b"\r\n", 1)[0].decode(), "y": y,
            "x": x, "wall_s": wall, "first_out_s": first_out,
            "si_sdr": (sdr_in, sdr_out)}


def energy_sdr(est, s, n):
    from ..metrics import energy_ratios

    return energy_ratios(np.asarray(est)[: len(s)], s, n)[0]


if __name__ == "__main__":
    main()
