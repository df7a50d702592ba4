"""Low-delay P encoder end-to-end tests."""
import os

import numpy as np

from tests.conftest import DATA, load_yuv8
from xeve_jax.api import Encoder, psnr
from xeve_jax.params import EncoderParams
from xeve_jax.dec.decoder import BaselineIntraDecoder


def test_ldp_encode_decode_roundtrip():
    w, h = 96, 80
    enc = Encoder(EncoderParams(w=w, h=h, qp=30, keyint=0), coder="numpy")
    bs_all = b""
    recs = []
    for i in range(3):
        y8, u8, v8 = load_yuv8(os.path.join(DATA, "s96b.yuv"), w, h, i)
        bs, rec = enc.encode_frame(y8 << 2, u8 << 2, v8 << 2)
        bs_all += bs
        recs.append(rec)
    frames = BaselineIntraDecoder().decode(bs_all)
    assert len(frames) == 3
    for i, f in enumerate(frames):
        ry, ru, rv = recs[i]
        assert np.array_equal(f.y, ry), f"frame {i} luma"
        assert np.array_equal(f.u, ru), f"frame {i} cb"
        assert np.array_equal(f.v, rv), f"frame {i} cr"
    # P frames must be much cheaper than the I frame
    assert frames[1].slice_type != frames[0].slice_type


def test_ldp_quality_sane():
    w, h = 96, 80
    enc = Encoder(EncoderParams(w=w, h=h, qp=30, keyint=0), coder="numpy")
    for i in range(3):
        y8, u8, v8 = load_yuv8(os.path.join(DATA, "s96b.yuv"), w, h, i)
        bs, (ry, _, _) = enc.encode_frame(y8 << 2, u8 << 2, v8 << 2)
        assert psnr(ry, y8 << 2) > 33.0


def test_mc_kernels_integer_copy():
    from xeve_jax.ops import mc_np
    rng = np.random.RandomState(0)
    ref = rng.randint(0, 1024, (64, 64)).astype(np.int32)
    pad = 80
    ref_pad = mc_np.pad_picture(ref, pad)
    # integer MV = pure copy
    out = mc_np.mc_luma(ref_pad, pad, (8 << 4), (4 << 4), 16, 16, 10)
    assert np.array_equal(out, ref[4:20, 8:24])
    # half-pel horizontal: filtered, stays in range
    out = mc_np.mc_luma(ref_pad, pad, (8 << 4) + 8, (4 << 4), 16, 16, 10)
    assert out.shape == (16, 16) and out.min() >= 0 and out.max() <= 1023


def test_ra_gop16_encode_decode_roundtrip():
    """RA hierarchical-B encoding: 20 frames through push/flush, coding
    order must match the reference GOP16 structure, and the stream must
    decode bit-exactly."""
    from xeve_jax.api import GopEncoder
    w, h = 96, 80
    enc = GopEncoder(EncoderParams(w=w, h=h, qp=30, keyint=0, bframes=15),
                     coder="numpy")
    bs_all = b""
    recs = {}
    for i in range(18):
        y8, u8, v8 = load_yuv8(os.path.join(DATA, "s96c.yuv"), w, h, i)
        for bs, rec, poc in enc.push_frame(y8 << 2, u8 << 2, v8 << 2):
            bs_all += bs
            recs[poc] = rec
    for bs, rec, poc in enc.flush():
        bs_all += bs
        recs[poc] = rec
    frames = BaselineIntraDecoder().decode(bs_all)
    assert len(frames) == 18
    assert [f.poc for f in frames][:9] == [0, 16, 8, 4, 12, 2, 6, 10, 14]
    for f in frames:
        ry, ru, rv = recs[f.poc]
        assert np.array_equal(f.y, ry), f"poc {f.poc} luma"
        assert np.array_equal(f.u, ru)
        assert np.array_equal(f.v, rv)


def test_rate_control_abr_tracks_target():
    w, h = 96, 80
    enc = Encoder(EncoderParams(w=w, h=h, keyint=0, rc_type="abr",
                                bitrate_kbps=150, fps=30), coder="numpy")
    tot = 0
    for i in range(6):
        y8, u8, v8 = load_yuv8(os.path.join(DATA, "s96b.yuv"), w, h, i)
        bs, _ = enc.encode_frame(y8 << 2, u8 << 2, v8 << 2)
        tot += len(bs)
    kbps = tot * 8 * 30 / 6 / 1000
    assert 75 < kbps < 300, f"ABR off target: {kbps} kbps for 150 target"


def test_rate_control_crf_monotonic():
    w, h = 96, 80
    sizes = []
    for crf in (27, 37):
        enc = Encoder(EncoderParams(w=w, h=h, keyint=0, rc_type="crf",
                                    crf=crf, fps=30), coder="numpy")
        tot = 0
        for i in range(4):
            y8, u8, v8 = load_yuv8(os.path.join(DATA, "s96b.yuv"), w, h, i)
            bs, _ = enc.encode_frame(y8 << 2, u8 << 2, v8 << 2)
            tot += len(bs)
        sizes.append(tot)
    assert sizes[0] > sizes[1]
