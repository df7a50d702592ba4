"""Config get/set + per-AU stat surface (xeve_config, xeve.c:148-314;
XEVE_STAT, inc/xeve.h:563-585)."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from xeve_jax.api import Encoder, GopEncoder
from xeve_jax.params import EncoderParams
from xeve_jax.constants import SLICE_I, SLICE_P, NUT_IDR


def _frames(n, w=96, h=80):
    from tools.gen_test_content import gen_frame
    out = []
    for t in range(n):
        y, u, v = gen_frame(w, h, t)
        out.append((y.astype(np.int16) << 2, u.astype(np.int16) << 2,
                    v.astype(np.int16) << 2))
    return out


def test_stat_fields():
    frames = _frames(4)
    p = EncoderParams(w=96, h=80, qp=30, keyint=0, bframes=0, ref_pics=2)
    enc = Encoder(p, analysis="numpy", coder="native")
    bs0, _ = enc.encode_frame(*frames[0])
    st = enc.config_get("stat")
    assert st.slice_type == SLICE_I and st.poc == 0
    assert st.nalu_type == NUT_IDR and st.bytes == len(bs0)
    for i, f in enumerate(frames[1:], 1):
        bs, _ = enc.encode_frame(*f)
        st = enc.config_get("stat")
        assert st.slice_type == SLICE_P and st.poc == i
        assert st.bytes == len(bs)
        assert st.ref_pocs_l0[0] == i - 1
    assert len(st.ref_pocs_l0) == 2          # multi-ref list visible


def test_config_set_qp_mid_stream():
    frames = _frames(6)
    p = EncoderParams(w=96, h=80, qp=30, keyint=0, bframes=0)
    enc = Encoder(p, analysis="numpy", coder="native")
    for f in frames[:3]:
        enc.encode_frame(*f)
    q1 = enc.config_get("stat").qp
    enc.config_set("qp", 45)
    for f in frames[3:]:
        enc.encode_frame(*f)
    q2 = enc.config_get("stat").qp
    assert q2 > q1

    # recon getter mirrors the last AU
    rec = enc.config_get("recon")
    assert rec is not None and rec[0].shape == (80, 96)

    with pytest.raises(KeyError):
        enc.config_set("nonsense", 1)


def test_stat_ra_tids():
    frames = _frames(18)
    p = EncoderParams(w=96, h=80, qp=30, keyint=0, bframes=15)
    enc = GopEncoder(p, analysis="numpy", coder="native")
    tids = []
    for f in frames:
        for _ in enc.push_frame(*f):
            tids.append(enc.config_get("stat").tid)
    for _ in enc.flush():
        tids.append(enc.config_get("stat").tid)
    assert len(tids) == 18
    assert max(tids) >= 3 and tids[0] == 0    # hierarchical GOP visible


def test_param_strings_and_config_file(tmp_path):
    """3-level config completion (xeve_param_parse.c:275 typed kv +
    app --config file)."""
    from xeve_jax.params import (EncoderParams, apply_param_strings,
                                 params_from_config_file)
    p = EncoderParams(w=96, h=80)
    apply_param_strings(p, ["qp=27", "use_deblock=0", "fps = 24",
                            "preset=slow  # comment"])
    assert (p.qp, p.use_deblock, p.fps, p.preset) == (27, False, 24.0,
                                                      "slow")
    cfg = tmp_path / "enc.cfg"
    cfg.write_text("# my config\nqp = 41\nref_pics = 2\n\naq_mode=1\n")
    p2 = params_from_config_file(str(cfg), EncoderParams(w=96, h=80))
    assert (p2.qp, p2.ref_pics, p2.aq_mode) == (41, 2, 1)
    with pytest.raises(KeyError):
        apply_param_strings(p, ["bogus=1"])
