"""JAX analysis stage: decision agreement vs exact-integer numpy oracle, and
multi-chip sharding (virtual CPU mesh from conftest)."""
import os

import numpy as np
import pytest

from tests.conftest import DATA, load_yuv8
from xeve_jax.constants import chroma_qp_dynamic


def test_jax_analysis_agrees_with_numpy():
    from xeve_jax.enc.analysis_np import analyze_frame
    from xeve_jax.enc.analysis_jax import analyze_frame_jax
    w, h = 96, 80
    y8, u8, v8 = load_yuv8(os.path.join(DATA, "s96.yuv"), w, h, 0)
    y, u, v = y8 << 2, u8 << 2, v8 << 2
    qp = 32
    qp_y = qp + 12
    qp_u = chroma_qp_dynamic(qp) + 12
    a_np = analyze_frame(y, u, v, qp, qp_y, qp_u, qp_u, 10)
    a_jx = analyze_frame_jax(y, u, v, qp, qp_y, qp_u, qp_u, 10)
    for lg in a_np.mode:
        agree = (a_np.mode[lg] == a_jx.mode[lg]).mean()
        assert agree > 0.90, f"level {lg}: mode agreement {agree}"
        if lg in a_np.split:
            s_agree = (a_np.split[lg] == a_jx.split[lg]).mean()
            assert s_agree > 0.90, f"level {lg}: split agreement {s_agree}"


def test_batch_analyzer_matches_single():
    from xeve_jax.enc.analysis_jax import BatchAnalyzer, analyze_frame_jax
    w, h = 96, 80
    frames = []
    for i in range(2):
        y8, u8, v8 = load_yuv8(os.path.join(DATA, "s96.yuv"), w, h, i)
        frames.append((np.asarray(y8 << 2, np.int16),
                       np.asarray(u8 << 2, np.int16),
                       np.asarray(v8 << 2, np.int16)))
    qp = 27
    qp_y = qp + 12
    qp_u = chroma_qp_dynamic(qp) + 12
    ba = BatchAnalyzer(w, h, qp, qp_y, qp_u, qp_u)
    res = ba.analyze(frames)
    ref = analyze_frame_jax(frames[1][0], frames[1][1], frames[1][2],
                            qp, qp_y, qp_u, qp_u, 10)
    for lg in ref.mode:
        assert np.array_equal(res[1].mode[lg], ref.mode[lg])
        assert np.array_equal(res[1].split[lg], ref.split[lg])


def test_meshed_analysis_multichip():
    import jax
    if len(jax.devices()) < 2:
        pytest.skip("needs multi-device (virtual) platform")
    import __graft_entry__ as ge
    ge.dryrun_multichip(min(8, len(jax.devices())))


def test_me_jax_agrees_with_numpy():
    """XLA full-search integer ME (me_jax) vs the exact numpy oracle."""
    import jax
    from xeve_jax.ops import mc_np
    from xeve_jax.enc.analysis_inter_np import integer_me
    y0, _, _ = load_yuv8(os.path.join(DATA, "s96b.yuv"), 96, 80, 0)
    y1, _, _ = load_yuv8(os.path.join(DATA, "s96b.yuv"), 96, 80, 1)
    ref_pad = mc_np.pad_picture((y0 << 2).astype(np.int32), 80)
    cur = (y1 << 2).astype(np.int32)
    mv_np, _ = integer_me(cur, ref_pad, 80, 8)
    from xeve_jax.enc.me_jax import integer_me_jax
    mv_jx, _ = integer_me_jax(cur, ref_pad, 80, 8)
    assert (mv_np == np.asarray(mv_jx)).all()


def _dot_precisions(jaxpr):
    """precision params of every dot_general in a jaxpr, sub-jaxprs
    (scan / pjit / cond bodies) included."""
    from jax.extend.core import ClosedJaxpr, Jaxpr
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                if isinstance(sub, ClosedJaxpr):
                    out += _dot_precisions(sub.jaxpr)
                elif isinstance(sub, Jaxpr):
                    out += _dot_precisions(sub)
    return out


def _graph(name):
    """(fn, args, has_matmuls) for one analysis graph at 96x80."""
    import functools
    import jax.numpy as jnp
    from xeve_jax.enc import (analysis_jax, analysis_main_jax,
                              analysis_inter_jax, device_analyzer as da)
    from xeve_jax.ops import mc_np
    w, h = 96, 80
    rng = np.random.RandomState(0)
    yuv = [jnp.asarray(rng.randint(0, 1024, s), jnp.int16)
           for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    prms, prm3 = da.fused_params(32, 44, 43, 43, 10, 2, 6)
    if name.startswith("fused"):
        refine = name == "fused_B"
        fn = functools.partial(da._fused_impl, bd=10, R=16, pad=da.PAD,
                               min_log2=2, max_log2=6, refine=refine)
        refs = (tuple(yuv), None, tuple(yuv) if refine else None, None) \
            if name != "fused_I" else (None, None, None, None)
        return fn, (*yuv, *refs, prms, prm3), True
    f32 = [p.astype(jnp.float32) for p in yuv]
    if name == "level_cost":
        return (functools.partial(analysis_jax._level_cost_impl, bd=10, lg=3),
                (*f32, analysis_jax.level_params(32, 44, 43, 43, 10, 3)),
                True)
    if name == "level_cost_main":
        return (functools.partial(analysis_main_jax._level_cost_main_impl,
                                  bd=10, lg=3),
                (*f32, analysis_main_jax.level_params_main(
                    32, 44, 43, 43, 10, 3)), True)
    pad = analysis_inter_jax.PAD
    i32 = [p.astype(jnp.int32) for p in yuv]
    refp = [jnp.asarray(mc_np.pad_picture(np.asarray(p), pd), jnp.int32)
            for p, pd in zip(i32, (pad, pad // 2, pad // 2))]
    kw = dict(R=8, bd=10, pad=pad, min_log2=2, max_log2=6)
    if name == "inter_costs":
        return (lambda *a: analysis_inter_jax._inter_costs_jit(*a, **kw),
                (*i32, *refp, prm3), False)
    return (lambda *a: analysis_inter_jax._mv_only_jit(*a, **kw),
            (i32[0], refp[0]), False)


@pytest.mark.parametrize("name", ["fused_I", "fused_P", "fused_B",
                                  "level_cost", "level_cost_main",
                                  "inter_costs", "mv_only"])
def test_analysis_matmuls_name_their_precision(name):
    """Every matmul of the device analysis graphs names a non-DEFAULT
    precision, so a GPU computes the f32 products the CPU tests verify
    instead of the TF32/bf16 it may pick by default."""
    import jax
    fn, args, has_matmuls = _graph(name)
    precs = _dot_precisions(jax.make_jaxpr(fn)(*args).jaxpr)
    assert bool(precs) == has_matmuls, (name, len(precs))
    default = jax.lax.Precision.DEFAULT
    for p in precs:
        assert p is not None and all(q not in (None, default) for q in p), p
