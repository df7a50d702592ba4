"""Native C inter coding pass (xt_encode_frame) vs the numpy FramePass
oracle: byte-identical bitstreams and recon for P and hierarchical-B."""
import numpy as np
import pytest

from xeve_jax.params import EncoderParams
from xeve_jax.api import Encoder, GopEncoder


def synth(n, w, h, seed=3):
    rng = np.random.default_rng(seed)
    base_y = rng.integers(64, 900, (h, w)).astype(np.int32)
    frames = []
    for t in range(n):
        y = np.roll(base_y, (t * 2, t * 3), axis=(0, 1)) \
            + rng.integers(-8, 8, (h, w))
        u = rng.integers(400, 600, (h // 2, w // 2)).astype(np.int32)
        v = np.roll(u, t, axis=1)
        frames.append((np.clip(y, 0, 1023), np.clip(u, 0, 1023), v))
    return frames


def _assert_same(a, b):
    assert len(a) == len(b)
    for i, (ea, eb) in enumerate(zip(a, b)):
        assert ea[0] == eb[0], f"entry {i}: bitstream mismatch"
        for pl in range(3):
            assert np.array_equal(ea[1][pl], eb[1][pl]), \
                f"entry {i} plane {pl}: recon mismatch"


def test_native_p_matches_oracle():
    frames = synth(3, 128, 64)
    outs = {}
    for coder in ("numpy", "native"):
        enc = Encoder(EncoderParams(w=128, h=64, qp=32, keyint=0,
                                    exact_rd=0),
                      analysis="numpy", coder=coder)
        outs[coder] = [enc.encode_frame(*f) for f in frames]
    _assert_same(outs["numpy"], outs["native"])


def test_native_ra_b_matches_oracle():
    frames = synth(18, 64, 64)
    outs = {}
    for coder in ("numpy", "native"):
        enc = GopEncoder(EncoderParams(w=64, h=64, qp=34, keyint=0,
                                       bframes=15, exact_rd=0),
                         analysis="numpy", coder=coder)
        res = []
        for f in frames:
            res.extend(enc.push_frame(*f))
        res.extend(enc.flush())
        outs[coder] = [(bs, rec) for (bs, rec, _poc) in res]
    _assert_same(outs["numpy"], outs["native"])


def test_native_p_decodes():
    """Native-coded LD-P stream round-trips through the own decoder."""
    from xeve_jax.dec.decoder import BaselineIntraDecoder
    frames = synth(4, 128, 64, seed=11)
    enc = Encoder(EncoderParams(w=128, h=64, qp=30, keyint=0),
                  analysis="numpy", coder="native")
    bs_all = b""
    recs = []
    for f in frames:
        bs, rec = enc.encode_frame(*f)
        bs_all += bs
        recs.append(rec)
    decoded = BaselineIntraDecoder().decode(bs_all)
    assert len(decoded) == len(frames)
    for i, df in enumerate(decoded):
        for pl, dec in enumerate((df.y, df.u, df.v)):
            assert np.array_equal(np.asarray(dec, np.int32),
                                  np.asarray(recs[i][pl], np.int32)), \
                f"frame {i} plane {pl}: decode != encoder recon"
