"""Encoder end-to-end: our bitstream must decode (with the conformance
decoder) to exactly the encoder's own reconstruction, at sane quality."""
import os

import numpy as np

from xeve_jax.api import Encoder, psnr
from xeve_jax.params import EncoderParams
from xeve_jax.dec.decoder import BaselineIntraDecoder
from tests.conftest import DATA, load_yuv8


def test_encode_decode_roundtrip_s96():
    w, h = 96, 80
    y8, u8, v8 = load_yuv8(os.path.join(DATA, "s96.yuv"), w, h, 0)
    y, u, v = y8 << 2, u8 << 2, v8 << 2
    enc = Encoder(EncoderParams(w=w, h=h, qp=27, keyint=1, use_pic_sign=True))
    bs, (ry, ru, rv) = enc.encode_frame(y, u, v)
    frames = BaselineIntraDecoder().decode(bs)
    assert len(frames) == 1
    f = frames[0]
    assert np.array_equal(f.y, ry)
    assert np.array_equal(f.u, ru)
    assert np.array_equal(f.v, rv)
    assert psnr(f.y, y) > 35.0


def test_encode_qp_ladder_monotonic():
    w, h = 96, 80
    y8, u8, v8 = load_yuv8(os.path.join(DATA, "s96.yuv"), w, h, 0)
    y, u, v = y8 << 2, u8 << 2, v8 << 2
    sizes, psnrs = [], []
    for qp in (22, 32, 42):
        enc = Encoder(EncoderParams(w=w, h=h, qp=qp, keyint=1))
        bs, (ry, _, _) = enc.encode_frame(y, u, v)
        sizes.append(len(bs))
        psnrs.append(psnr(ry, y))
    assert sizes[0] > sizes[1] > sizes[2]
    assert psnrs[0] > psnrs[1] > psnrs[2]


def test_no_deblock_and_no_rdoq_paths():
    w, h = 96, 80
    y8, u8, v8 = load_yuv8(os.path.join(DATA, "s96.yuv"), w, h, 0)
    y, u, v = y8 << 2, u8 << 2, v8 << 2
    enc = Encoder(EncoderParams(w=w, h=h, qp=30, keyint=1,
                                use_deblock=False, rdoq=False))
    bs, (ry, ru, rv) = enc.encode_frame(y, u, v)
    f = BaselineIntraDecoder().decode(bs)[0]
    assert np.array_equal(f.y, ry)
    assert np.array_equal(f.u, ru)
    assert np.array_equal(f.v, rv)


def test_arbitrary_resolution_with_crop():
    """Non-multiple-of-8 frames are coded at the aligned size with SPS
    cropping; round-trip stays bit-exact and crop metadata is exposed."""
    rng = np.random.RandomState(3)
    w, h = 90, 70
    y = rng.randint(0, 1024, (h, w)).astype(np.int32)
    u = rng.randint(0, 1024, (h // 2, w // 2)).astype(np.int32)
    v = rng.randint(0, 1024, (h // 2, w // 2)).astype(np.int32)
    enc = Encoder(EncoderParams(w=w, h=h, qp=30, keyint=1), coder="numpy")
    bs, (ry, ru, rv) = enc.encode_frame(y, u, v)
    f = BaselineIntraDecoder().decode(bs)[0]
    assert f.y.shape == (72, 96)
    assert np.array_equal(f.y, ry)
    dy, du, dv = f.display()
    assert dy.shape == (70, 90)


def test_main_profile_roundtrip():
    """Our encoder can emit Main-profile streams (tool flags all off); the
    conformance decoder round-trips them bit-exactly incl. signature SEI."""
    import numpy as np
    from xeve_jax.api import Encoder
    from xeve_jax.params import EncoderParams
    from xeve_jax.dec.decoder import BaselineIntraDecoder
    from tests.conftest import DATA, load_yuv8
    import os
    y, u, v = load_yuv8(os.path.join(DATA, "s96.yuv"), 96, 80, 0)
    enc = Encoder(EncoderParams(w=96, h=80, qp=30, keyint=1, profile=1,
                                use_pic_sign=True))
    bs, (ry, ru, rv) = enc.encode_frame(y, u, v)
    dec = BaselineIntraDecoder()
    frames = dec.decode(bs)
    assert dec.sps.profile_idc == 1 and dec.sps.dquant_flag == 1
    assert dec.signatures_checked == 1
    assert np.array_equal(frames[0].y, ry)
    assert np.array_equal(frames[0].u, ru)
    assert np.array_equal(frames[0].v, rv)


def test_presets_and_tunes():
    """Preset ladder (xeve_param_ppt counterpart): every preset produces a
    valid stream; fast uses a smaller ME window and no 4x4 CUs."""
    import numpy as np
    from xeve_jax.api import Encoder
    from xeve_jax.params import EncoderParams
    from xeve_jax.dec.decoder import BaselineIntraDecoder
    rng = np.random.RandomState(3)
    y = rng.randint(0, 1024, (80, 96))
    u = rng.randint(0, 1024, (40, 48))
    v = rng.randint(0, 1024, (40, 48))
    sizes = {}
    for preset in ("fast", "medium", "slow"):
        p = EncoderParams(w=96, h=80, qp=30, keyint=1, preset=preset)
        enc = Encoder(p)
        bs, rec = enc.encode_frame(y, u, v)
        f = BaselineIntraDecoder().decode(bs)[0]
        assert np.array_equal(f.y, rec[0])
        sizes[preset] = len(bs)
    assert EncoderParams(w=960, h=540, preset="fast").validate().search_range == 8
    assert EncoderParams(w=960, h=540, preset="slow").validate().search_range == 24
    p = EncoderParams(w=96, h=80, bframes=15, tune="zerolatency").validate()
    assert p.bframes == 0
