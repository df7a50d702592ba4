#!/usr/bin/env python
"""xeve_jax_dec: conformance decoder CLI — decodes EVC Baseline streams
(ours or the reference encoder's) and dumps 10-bit recon YUV."""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description="EVC conformance decoder")
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-o", "--output", help="recon YUV (10-bit LE planar)")
    ap.add_argument("-v", "--verbose", type=int, default=2)
    args = ap.parse_args()

    from xeve_jax.dec.decoder import BaselineIntraDecoder, DecodeError
    from xeve_jax.io.video import write_recon_frame

    stream = open(args.input, "rb").read()
    try:
        frames = BaselineIntraDecoder().decode(stream)
    except DecodeError as e:
        print(f"error: {e}", file=sys.stderr)
        sys.exit(1)
    if args.verbose >= 2:
        for f in frames:
            st = {0: "B", 1: "P", 2: "I"}.get(f.slice_type, "?")
            print(f"poc {f.poc}  {st}-slice  qp {f.qp}  {f.y.shape[1]}x{f.y.shape[0]}")
        print(f"decoded {len(frames)} frames")
    if args.output:
        with open(args.output, "wb") as fo:
            for f in frames:
                write_recon_frame(fo, f.y, f.u, f.v)


if __name__ == "__main__":
    main()
