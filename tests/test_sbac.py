import random

from xeve_jax.entropy.sbac import SbacEncoder, SbacDecoder, ctx_array


def test_sbac_roundtrip_random():
    random.seed(7)
    for _ in range(50):
        n = random.randint(1, 800)
        enc = SbacEncoder()
        models = ctx_array(6)
        seq = []
        for _ in range(n):
            r = random.random()
            if r < 0.5:
                b, c = random.randint(0, 1), random.randint(0, 5)
                enc.encode_bin(b, models, c)
                seq.append(("ctx", c, b))
            elif r < 0.8:
                b = random.randint(0, 1)
                enc.encode_bin_ep(b)
                seq.append(("ep", None, b))
            else:
                s = random.randint(0, 10)
                enc.write_unary_sym(s, models, 0, 2)
                seq.append(("unary", None, s))
        enc.encode_bin_trm(1)
        data = enc.finish()

        dec = SbacDecoder(data)
        m2 = ctx_array(6)
        for kind, c, val in seq:
            if kind == "ctx":
                assert dec.decode_bin(m2, c) == val
            elif kind == "ep":
                assert dec.decode_bin_ep() == val
            else:
                assert dec.read_unary_sym(m2, 0, 2) == val
        assert dec.decode_bin_trm() == 1


def test_sbac_skewed_contexts():
    """Exercise carry propagation / 0xFF stacking with highly skewed bins."""
    enc = SbacEncoder()
    models = ctx_array(1)
    bits = [1] * 2000 + [0, 1] * 50
    for b in bits:
        enc.encode_bin(b, models, 0)
    enc.encode_bin_trm(1)
    data = enc.finish()
    dec = SbacDecoder(data)
    m2 = ctx_array(1)
    for b in bits:
        assert dec.decode_bin(m2, 0) == b
    assert dec.decode_bin_trm() == 1
