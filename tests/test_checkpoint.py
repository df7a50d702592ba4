"""Checkpoint/resume (SURVEY.md §5.4): stop an encode mid-stream, restore
into a fresh encoder, and the concatenated output must equal the unbroken
encode byte for byte."""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from xeve_jax.api import Encoder, GopEncoder
from xeve_jax.params import EncoderParams
from xeve_jax.state import save_state, load_state
from xeve_jax.dec.decoder import BaselineIntraDecoder


def _frames(n, w=96, h=80):
    from tools.gen_test_content import gen_frame
    out = []
    for t in range(n):
        y, u, v = gen_frame(w, h, t)
        out.append((y.astype(np.int16) << 2, u.astype(np.int16) << 2,
                    v.astype(np.int16) << 2))
    return out


def _push_all(enc, frames, ra):
    bs = b""
    for f in frames:
        if ra:
            bs += b"".join(o[0] for o in enc.push_frame(*f))
        else:
            bs += enc.encode_frame(*f)[0]
    return bs


def _run(cls, p, frames, ra=False):
    enc = cls(p, analysis="numpy", coder="native")
    bs = _push_all(enc, frames, ra)
    if ra:
        bs += b"".join(o[0] for o in enc.flush())
    return bs


def _run_split(cls, p, frames, cut, ra=False):
    enc = cls(p, analysis="numpy", coder="native")
    bs = _push_all(enc, frames[:cut], ra)
    blob = save_state(enc)
    enc2 = cls(p, analysis="numpy", coder="native")
    load_state(enc2, blob)
    bs += _push_all(enc2, frames[cut:], ra)
    if ra:
        bs += b"".join(o[0] for o in enc2.flush())
    return bs


def test_resume_ld_bit_exact():
    frames = _frames(10)
    p = EncoderParams(w=96, h=80, qp=30, keyint=0, bframes=0)
    assert _run(Encoder, p, frames) == _run_split(Encoder, p, frames, 5)


def test_resume_ld_rc_bit_exact():
    frames = _frames(10)
    p = EncoderParams(w=96, h=80, keyint=0, bframes=0, rc_type="abr",
                      bitrate_kbps=300, fps=30)
    assert _run(Encoder, p, frames) == _run_split(Encoder, p, frames, 6)


def test_resume_ra_bit_exact():
    """Cut inside the GOP reorder buffer: the buffered display frames and
    derivation state must survive the checkpoint."""
    frames = _frames(40)
    p = EncoderParams(w=96, h=80, qp=30, keyint=0, bframes=15)
    whole = _run(GopEncoder, p, frames, ra=True)
    for cut in (8, 17, 25):
        assert whole == _run_split(GopEncoder, p, frames, cut, ra=True), \
            f"cut {cut}"


def test_resume_stream_decodes():
    frames = _frames(12)
    p = EncoderParams(w=96, h=80, qp=30, keyint=0, bframes=0, aq_mode=1)
    bs = _run_split(Encoder, p, frames, 7)
    assert len(BaselineIntraDecoder().decode(bs)) == 12
