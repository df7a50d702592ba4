"""Lookahead-lite rate control (round-3 ask #9): the dispatch-ahead
pipeline's complexity proxies act as a forecast window — ABR targets are
allocated proportionally within the window, the VBV pre-clips before an
overshoot lands, and a hard scene change inserts a keyframe
(xeve_fcst.c:106 / xeve_rc.c:598 analogs)."""
import numpy as np

from xeve_jax.api import Encoder
from xeve_jax.params import EncoderParams
from xeve_jax.constants import SLICE_I
from xeve_jax.dec.decoder import BaselineIntraDecoder

W, H, FPS = 96, 80, 30.0


def _scene_clip(n, cut):
    """Controlled content: a slow-moving box over a gradient, with a hard
    scene change (inverted, reshuffled texture) at `cut`."""
    rng = np.random.RandomState(7)
    tex_a = rng.randint(0, 40, (H, W)).astype(np.int32)
    tex_b = rng.randint(0, 40, (H, W)).astype(np.int32)
    grad = (np.arange(W)[None, :] * 2 + np.arange(H)[:, None]).astype(np.int32)
    out = []
    for t in range(n):
        if t < cut:
            y = (grad + tex_a) % 256
        else:
            y = (255 - (grad[:, ::-1] + tex_b) % 256)
        y = y.copy()
        x0 = (4 + 2 * t) % (W - 16)
        y[20:36, x0:x0 + 16] = 220
        u = np.full((H // 2, W // 2), 120, np.int32)
        v = np.full((H // 2, W // 2), 130, np.int32)
        out.append(((y << 2).astype(np.int16), (u << 2).astype(np.int16),
                    (v << 2).astype(np.int16)))
    return out


def test_scene_cut_keyframe_and_abr():
    n, cut = 60, 30
    frames = _scene_clip(n, cut)
    kbps = 150.0
    enc = Encoder(EncoderParams(w=W, h=H, qp=32, keyint=0, rc_type="abr",
                                bitrate_kbps=kbps, fps=FPS),
                  analysis="device")
    total = 0
    slice_types = []
    qps = []
    vbv_ok = True
    bs_all = b""
    for bs, rec, poc in enc.encode_stream(iter(frames)):
        total += len(bs)
        bs_all += bs
        slice_types.append(enc.last_stat.slice_type)
        qps.append(enc.last_stat.qp)
        if enc.rc.vbv_fullness > enc.rc.vbv_size:
            vbv_ok = False

    # scene cut detected and coded as an I slice
    assert cut in enc._force_idr
    assert slice_types[cut] == SLICE_I
    # VBV buffer never overflowed
    assert vbv_ok
    # ABR lands near the target even across the cut
    target_bits = kbps * 1000.0 * n / FPS
    err = abs(total * 8 - target_bits) / target_bits
    # an UNDERshoot with the qp pinned at the floor is correct behavior:
    # the exact-RD coder cannot be forced to spend more bits at qp_min
    floor_limited = (total * 8 < target_bits and min(qps) == enc.rc.qp_min)
    assert err < 0.15 or floor_limited, \
        f"ABR error {err:.1%} (got {total * 8} vs {target_bits}, qps {sorted(set(qps))})"
    # stream stays decodable (mid-stream non-IDR I slice)
    dec = BaselineIntraDecoder().decode(bs_all)
    assert len(dec) == n


def test_forecast_tightens_before_the_cut():
    """The frame just before the cut must not get a LOWER qp than it
    would with a flat target (the forecast sees the complexity jump in
    the pipeline and withholds bits)."""
    from xeve_jax.enc.rc import RateControl
    rc_flat = RateControl("abr", W, H, FPS, bitrate_kbps=200.0)
    rc_fcst = RateControl("abr", W, H, FPS, bitrate_kbps=200.0)
    # warm both models identically
    for rc in (rc_flat, rc_fcst):
        for i in range(5):
            qp = rc.pick_qp(1, 0, 1000.0)
            rc.update(1, qp, int(200000 / 30), 1000.0)
    q_flat = rc_flat.pick_qp(1, 0, 1000.0)
    # forecast: the easy current frame is 1/5 of the window mean
    q_fcst = rc_fcst.pick_qp(1, 0, 1000.0, fcst_ratio=0.2)
    assert q_fcst > q_flat
