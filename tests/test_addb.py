"""ADDB — advanced deblocking filter (xevem_df.c).

Golden conformance: reference-encoder streams with tool_addb=1 decode
bit-exactly (AI / LD / RA incl. B-slice BS ref comparison).  Encode:
native C twin is byte-exact vs the numpy oracle and streams round-trip."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from xeve_jax.api import Encoder, GopEncoder
from xeve_jax.params import EncoderParams
from xeve_jax.dec.decoder import BaselineIntraDecoder

DATA = os.path.join(os.path.dirname(__file__), "data")
W, H = 96, 80
FSZ = W * H + 2 * (W // 2) * (H // 2)


@pytest.mark.parametrize("name,reorder", [
    ("s96_addb_ai", False), ("s96_addb_ld", False), ("s96_addb_ra", True)])
def test_golden_addb_decode(name, reorder):
    bs = open(os.path.join(DATA, f"{name}.evc"), "rb").read()
    frames = BaselineIntraDecoder().decode(bs)
    if reorder:
        frames = sorted(frames, key=lambda f: f.poc)
    rec = np.fromfile(os.path.join(DATA, f"{name}_rec.yuv"), dtype="<u2")
    n = len(rec) // FSZ
    assert len(frames) == n
    for i, f in enumerate(frames):
        r = rec[i * FSZ:(i + 1) * FSZ]
        assert np.array_equal(f.y, r[:W * H].reshape(H, W)), f"{name} {i}"
        assert np.array_equal(
            f.u, r[W * H:W * H + (W // 2) * (H // 2)].reshape(H // 2, W // 2))
        assert np.array_equal(
            f.v, r[W * H + (W // 2) * (H // 2):].reshape(H // 2, W // 2))


def _frames(n):
    from tools.gen_test_content import gen_frame
    out = []
    for t in range(n):
        y, u, v = gen_frame(W, H, t)
        out.append((y.astype(np.int16) << 2, u.astype(np.int16) << 2,
                    v.astype(np.int16) << 2))
    return out


def test_addb_native_oracle_parity():
    y, u, v = _frames(1)[0]
    p = dict(w=W, h=H, qp=30, keyint=1, profile=1, exact_rd=0)
    b1, r1 = Encoder(EncoderParams(**p), coder="numpy").encode_frame(y, u, v)
    b2, r2 = Encoder(EncoderParams(**p), coder="native").encode_frame(y, u, v)
    assert b1 == b2
    for a, b in zip(r1, r2):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("bf,ki", [(0, 1), (0, 0), (15, 0)])
def test_addb_roundtrip(bf, ki):
    frames = _frames(12)
    p = EncoderParams(w=W, h=H, qp=30, keyint=ki, bframes=bf, profile=1)
    assert p.validate().tool_addb == 1          # main default
    cls = GopEncoder if bf else Encoder
    enc = cls(p, analysis="numpy", coder="native")
    outs = list(enc.encode_stream(iter(frames)))
    bs = b"".join(o[0] for o in outs)
    dec = BaselineIntraDecoder().decode(bs)
    assert len(dec) == len(outs)
    for d, (_, rec, _) in zip(dec, outs):
        assert np.array_equal(d.y, rec[0])
        assert np.array_equal(d.u, rec[1])
        assert np.array_equal(d.v, rec[2])


def test_golden_full_default_toolset_ra():
    """One reference stream with OUR entire default Main toolset enabled at
    once (eipd+cm_init+adcc+iqt+ats+addb+htdf, RA hierarchical-B) decodes
    bit-exactly — combined-tool conformance, not just per-tool."""
    bs = open(os.path.join(DATA, "s96_fullset_ra.evc"), "rb").read()
    dec = BaselineIntraDecoder()
    frames = sorted(dec.decode(bs), key=lambda f: f.poc)
    assert (dec.sps.tool_eipd, dec.sps.tool_adcc, dec.sps.tool_ats,
            dec.sps.tool_addb, dec.sps.tool_htdf) == (1, 1, 1, 1, 1)
    rec = np.fromfile(os.path.join(DATA, "s96_fullset_ra_rec.yuv"),
                      dtype="<u2")
    n = len(rec) // FSZ
    assert len(frames) == n
    for i, f in enumerate(frames):
        r = rec[i * FSZ:(i + 1) * FSZ]
        assert np.array_equal(f.y, r[:W * H].reshape(H, W)), f"frame {i}"
