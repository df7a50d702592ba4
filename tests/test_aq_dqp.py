"""Adaptive quantization + cu_qp_delta coding (VERDICT r2 ask #7).

Encoder-side dqp (xeve_eco.c:896 binarization, xeve_eco.c:995 placement,
xeve_mode.c:727 quantization groups) against the in-repo decoder's
already-conformance-proven dqp parse, plus the variance AQ model
(xeve_fcst.c:271) and the golden reference AQ stream."""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from xeve_jax.api import Encoder, GopEncoder
from xeve_jax.params import EncoderParams
from xeve_jax.dec.decoder import BaselineIntraDecoder

DATA = os.path.join(os.path.dirname(__file__), "data")
W, H = 96, 80
FSZ = W * H + 2 * (W // 2) * (H // 2)


def _var_frames(n, w=W, h=H):
    """Content with strong variance contrast so AQ offsets are nonzero."""
    rng = np.random.default_rng(7)
    out = []
    noise = rng.integers(0, 255, (n, h, w // 2))
    for t in range(n):
        y = np.full((h, w), 120, np.int32)
        y[:, w // 2:] = noise[t]
        y[:h // 2, :w // 2] = 120 + (np.arange(w // 2)[None, :] // 6 + t)
        u = np.full((h // 2, w // 2), 512, np.int16)
        out.append((np.clip(y, 0, 255).astype(np.int16) << 2, u, u.copy()))
    return out


def test_golden_reference_aq_stream():
    """The reference encoder's aq_mode=1 stream (dqp coded at every cbf CU,
    baseline no-dquant rule) decodes bit-exactly."""
    bs = open(os.path.join(DATA, "s96v_aq_ld.evc"), "rb").read()
    frames = BaselineIntraDecoder().decode(bs)
    rec = np.fromfile(os.path.join(DATA, "s96v_aq_ld_rec.yuv"), dtype="<u2")
    assert len(frames) == len(rec) // FSZ
    for i, f in enumerate(frames):
        r = rec[i * FSZ:(i + 1) * FSZ]
        assert np.array_equal(f.y, r[:W * H].reshape(H, W)), f"frame {i}"


def test_aq_model_nonzero_offsets():
    from xeve_jax.enc.aq import aq_block_offsets
    (y, u, v) = _var_frames(1)[0]
    off = aq_block_offsets(y.astype(np.int32), u.astype(np.int32),
                           v.astype(np.int32), 10)
    assert off.min() < 0 < off.max(), "flat/noisy halves must split offsets"
    assert abs(int(off.sum())) <= off.size  # ~mean-normalized


def _roundtrip(p, frames):
    cls = GopEncoder if p.bframes >= 15 else Encoder
    enc = cls(p, analysis="numpy", coder="native")
    outs = list(enc.encode_stream(iter(frames)))
    bs = b"".join(o[0] for o in outs)
    dec = BaselineIntraDecoder().decode(bs)
    assert len(dec) == len(outs)
    for d, (_, rec, _) in zip(dec, outs):
        assert np.array_equal(d.y, rec[0])
        assert np.array_equal(d.u, rec[1])
        assert np.array_equal(d.v, rec[2])
    return bs


def test_own_aq_ai_roundtrip():
    frames = _var_frames(3)
    bs_aq = _roundtrip(EncoderParams(w=W, h=H, qp=32, keyint=1, aq_mode=1),
                       frames)
    bs_no = _roundtrip(EncoderParams(w=W, h=H, qp=32, keyint=1, aq_mode=0),
                       frames)
    assert bs_aq != bs_no, "AQ must actually change the coded stream"


def test_own_aq_ld_roundtrip():
    _roundtrip(EncoderParams(w=W, h=H, qp=32, keyint=0, bframes=0,
                             aq_mode=1), _var_frames(6))


def test_own_aq_ra_roundtrip():
    _roundtrip(EncoderParams(w=W, h=H, qp=32, keyint=0, bframes=15,
                             aq_mode=1), _var_frames(21))


def test_own_aq_main_roundtrip():
    """Main profile: sps dquant on -> quantization-group (area 10) rule."""
    _roundtrip(EncoderParams(w=W, h=H, qp=32, keyint=1, profile=1,
                             aq_mode=1), _var_frames(3))


def test_own_aq_main_ra_roundtrip():
    _roundtrip(EncoderParams(w=W, h=H, qp=32, keyint=0, bframes=15,
                             profile=1, aq_mode=1), _var_frames(21))
