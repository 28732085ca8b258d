"""The demos' shared flags."""

import argparse
import os
import tempfile

ART = "artifacts/pretrained"


def parser(doc, out=None):
    """An argument parser with the demos' flags: --data_root, --device,
    --artifacts and, where the demo writes files, --out (default
    `<temp dir>/<out>`)."""
    ap = argparse.ArgumentParser(
        description=doc.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter, epilog=doc)
    ap.add_argument("--data_root", default="data/subset",
                    help="a directory in the reference's subset layout "
                         "(raw/, processed/, pickle/)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--artifacts", default=ART,
                    help="the shipped checkpoints' directory")
    if out is not None:
        ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                      out))
    return ap


def device(args):
    from .._device import resolve_device

    return resolve_device(args.device)
