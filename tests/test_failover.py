"""Failure detection / recovery (SURVEY.md §5.3): a device loss during
analysis must not kill the encode — collect() re-dispatches once and then
falls back to the numpy oracle from the host-side original ring."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _frames(n, w=96, h=80):
    from tools.gen_test_content import gen_frame
    out = []
    for t in range(n):
        y, u, v = gen_frame(w, h, t)
        out.append((y.astype(np.int16) << 2, u.astype(np.int16) << 2,
                    v.astype(np.int16) << 2))
    return out


class _DeadVec:
    """A device buffer whose readback always fails (a lost device)."""
    def __array__(self, *a, **k):
        raise RuntimeError("device lost")


def test_collect_survives_device_loss():
    from xeve_jax.enc.device_analyzer import DeviceAnalyzer
    from xeve_jax.api import Encoder
    from xeve_jax.params import EncoderParams
    from xeve_jax.dec.decoder import BaselineIntraDecoder

    frames = _frames(5)
    p = EncoderParams(w=96, h=80, qp=30, keyint=0, bframes=0)
    enc = Encoder(p, analysis="device", coder="native")
    dev = enc._device()

    # sabotage: every dispatch returns a dead buffer AND re-dispatch dies
    # too -> the host fallback must carry every frame
    real_dispatch = DeviceAnalyzer.dispatch

    def dead_dispatch(self, *a, **k):
        hd = real_dispatch(self, *a, **k)
        hd.vec = _DeadVec()
        return hd

    dev.dispatch = dead_dispatch.__get__(dev)
    outs = list(enc.encode_stream(iter(frames)))
    assert len(outs) == 5
    assert dev.failures >= 1
    bs = b"".join(o[0] for o in outs)
    dec = BaselineIntraDecoder().decode(bs)
    assert len(dec) == 5
    for d, (_, rec, _) in zip(dec, outs):
        assert np.array_equal(d.y, rec[0])


def test_redispatch_recovers():
    """First readback fails once; the re-dispatch succeeds and the result
    equals an undisturbed run."""
    from xeve_jax.enc.device_analyzer import DeviceAnalyzer
    from xeve_jax.api import Encoder
    from xeve_jax.params import EncoderParams

    frames = _frames(3)
    p = EncoderParams(w=96, h=80, qp=30, keyint=0, bframes=0)

    enc0 = Encoder(p, analysis="device", coder="native")
    ref_bs = b"".join(o[0] for o in enc0.encode_stream(iter(frames)))

    enc = Encoder(p, analysis="device", coder="native")
    dev = enc._device()
    real_dispatch = DeviceAnalyzer.dispatch
    state = {"armed": True}

    def flaky_dispatch(self, *a, **k):
        hd = real_dispatch(self, *a, **k)
        if state["armed"]:
            state["armed"] = False
            good = hd.vec
            hd.vec = _DeadVec()
        return hd

    dev.dispatch = flaky_dispatch.__get__(dev)
    bs = b"".join(o[0] for o in enc.encode_stream(iter(frames)))
    assert dev.failures == 1
    assert bs == ref_bs


def test_recovery_logs_a_warning(caplog):
    """Every recovery says so: a warning with the exception for the
    failed readback and one for the failed re-dispatch."""
    import logging
    from xeve_jax.enc.device_analyzer import DeviceAnalyzer
    from xeve_jax.api import Encoder
    from xeve_jax.params import EncoderParams

    enc = Encoder(EncoderParams(w=96, h=80, qp=30, keyint=0, bframes=0),
                  analysis="device", coder="native")
    dev = enc._device()
    real_dispatch = DeviceAnalyzer.dispatch

    def dead_dispatch(self, *a, **k):
        hd = real_dispatch(self, *a, **k)
        hd.vec = _DeadVec()
        return hd

    dev.dispatch = dead_dispatch.__get__(dev)
    with caplog.at_level(logging.WARNING,
                         logger="xeve_jax.enc.device_analyzer"):
        outs = list(enc.encode_stream(iter(_frames(2))))
    assert len(outs) == 2 and dev.failures == 2
    msgs = [r.getMessage() for r in caplog.records
            if r.levelno == logging.WARNING]
    assert sum("re-dispatching" in m for m in msgs) == 2
    assert sum("numpy oracle" in m for m in msgs) == 2
    assert all("device lost" in m for m in msgs)
