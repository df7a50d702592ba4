"""Native C library must be bit-exact with the numpy oracle path."""
import os

import numpy as np
import pytest

from tests.conftest import DATA, load_yuv8
from xeve_jax.enc.analysis_np import analyze_frame
from xeve_jax.enc.frame_pass import FramePass as IntraFramePass
from xeve_jax.entropy.sbac import SbacEncoder, SbacCtx
from xeve_jax.constants import chroma_qp_dynamic


def _native_available():
    try:
        from xeve_jax.native.build import get_lib
        get_lib()
        return True
    except Exception:
        return False


needs_native = pytest.mark.skipif(not _native_available(),
                                  reason="native build unavailable")


@needs_native
@pytest.mark.parametrize("qp,rdoq,deblock", [(27, True, True),
                                             (37, True, False),
                                             (32, False, True)])
def test_native_pass_bitexact_vs_numpy(qp, rdoq, deblock):
    from xeve_jax.enc.intra_frame_native import encode_intra_frame_native
    w, h = 96, 80
    y8, u8, v8 = load_yuv8(os.path.join(DATA, "s96.yuv"), w, h, 0)
    y, u, v = y8 << 2, u8 << 2, v8 << 2
    bd = 10
    qp_y = qp + 12
    qp_u = chroma_qp_dynamic(qp) + 12
    an = analyze_frame(y, u, v, qp, qp_y, qp_u, qp_u, bd)

    sbac, ctx = SbacEncoder(), SbacCtx()
    fp = IntraFramePass(w, h, bd, 2, qp, 0, 0, use_rdoq=rdoq,
                        use_deblock=deblock)
    ry, ru, rv, _ = fp.encode(y, u, v, an, sbac, ctx)
    py_payload = sbac.finish()
    py_bins = sbac.bin_counter

    payload, bins, nry, nru, nrv, _tl = encode_intra_frame_native(
        w, h, bd, qp, 0, 0, y, u, v, an, use_rdoq=rdoq, use_deblock=deblock)
    assert payload == py_payload
    assert bins == py_bins
    assert np.array_equal(nry, ry)
    assert np.array_equal(nru, ru)
    assert np.array_equal(nrv, rv)


@needs_native
def test_native_encoder_roundtrip():
    from xeve_jax.api import Encoder
    from xeve_jax.params import EncoderParams
    from xeve_jax.dec.decoder import BaselineIntraDecoder
    w, h = 96, 80
    y8, u8, v8 = load_yuv8(os.path.join(DATA, "s96.yuv"), w, h, 0)
    y, u, v = y8 << 2, u8 << 2, v8 << 2
    enc = Encoder(EncoderParams(w=w, h=h, qp=30, keyint=1), coder="native")
    bs, (ry, ru, rv) = enc.encode_frame(y, u, v)
    f = BaselineIntraDecoder().decode(bs)[0]
    assert np.array_equal(f.y, ry)
    assert np.array_equal(f.u, ru)
    assert np.array_equal(f.v, rv)


def test_tables_h_matches_its_generator(tmp_path):
    """The committed tables.h is what gen_tables.py writes (the build
    never regenerates it)."""
    from xeve_jax.native import gen_tables
    out = tmp_path / "tables.h"
    gen_tables.main(str(out))
    here = os.path.join(os.path.dirname(gen_tables.__file__), "tables.h")
    assert out.read_bytes() == open(here, "rb").read()


def test_native_library_is_keyed_by_sources_flags_and_cpu():
    """A library built for another CPU, other flags or other sources has
    another name, so it is never loaded here."""
    from xeve_jax.native import build
    here = build.so_path()
    assert build.so_path(build.host_cpu_flags()) == here
    assert build.so_path(build.host_cpu_flags() + " other") != here
    assert os.path.dirname(here) == os.path.join(
        os.path.dirname(build.__file__), "build")
    flags = build.CFLAGS
    try:
        build.CFLAGS = flags + ("-DXT_OTHER",)
        assert build.so_path() != here
    finally:
        build.CFLAGS = flags
