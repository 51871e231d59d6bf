"""The port's compressor suite against the reference's.

Slices are made by the reference's generators and handed to both
packages as numpy arrays.  Every compressor of the 2-D study reproduces
each float32 step and is held bit for bit (codes, exponents and CR):
sz2 and sz3-regression fit their block planes with the reference's
float32 ``pinv`` (``_sz_design``) in the order of XLA's CPU dot.  The
reference's float32 ``log2``/``exp2``/``cumsum`` (XLA's CPU polynomials
and summation orders, which are not exact) are pinned here too: ZFP's
block exponent and bit length, Digit Rounding's grid and TTHRESH's
decode and threshold follow them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro import compressors as JC  # noqa: E402
from repro.compressors import base as JB  # noqa: E402
from repro.compressors import zfp as JZ  # noqa: E402
from repro.data import scientific as JS  # noqa: E402
from repro_torch import compressors as TC  # noqa: E402
from repro_torch import refmath  # noqa: E402
from repro_torch.compressors import base as TB  # noqa: E402
from repro_torch.compressors import sz as TSZ  # noqa: E402
from repro_torch.compressors import zfp as TZ  # noqa: E402

BIT_EQUAL = tuple(JC.STUDY_2D)
REGRESSION_FIT = ("sz2", "sz3-regression")
# the chip smoke's grid on cesm-cloud (eps 1e-5): 3.16e-6 ... 1e-3
CESM_EBS = (1e-5 * 10.0 ** np.linspace(-0.5, 2.0, 6)).tolist()


def _slice(field, shape, seed=1):
    x = np.array(JS.field_slices(field, count=1, n=max(shape), seed=seed)[0])
    return np.ascontiguousarray(x[:shape[0], :shape[1]])


@pytest.fixture(scope="module")
def cases():
    """(input, eps) pairs: square, ragged and 3-D inputs, relative ebs
    from 1e-4 to 1e-2 and cesm-cloud at both ends of the chip grid."""
    nyx = _slice("nyx-vx", (64, 64))
    rng = float(np.ptp(nyx))
    vol = np.array(JS.volume("miranda-vx", shape=(4, 24, 24)))
    cesm = _slice("cesm-cloud", (130, 70))
    return [(nyx, 1e-4 * rng), (nyx, 1e-2 * rng), (vol, 1e-3),
            (cesm, CESM_EBS[0]), (cesm, CESM_EBS[-1])]


def _leaves(codes):
    """The integer arrays of a compressor's code tree, in order."""
    if isinstance(codes, (tuple, list)):
        return [a for c in codes for a in _leaves(c)]
    if isinstance(codes, (str, int)):
        return []
    return [np.asarray(codes)]


@pytest.mark.parametrize("name", BIT_EQUAL)
def test_codes_and_cr_bit_equal(name, cases):
    for x, eps in cases:
        if x.ndim == 3 and not JC.get(name).supports_3d:
            continue
        jcodes, _ = JC.get(name).encode(jnp.asarray(x), eps)
        tcodes, _ = TC.get(name).encode(torch.from_numpy(x), eps)
        jl, tl = _leaves(jcodes), _leaves(tcodes)
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            np.testing.assert_array_equal(b.view(np.int32), a.view(np.int32))
        want = JC.get(name).cr(jnp.asarray(x), eps)
        assert TC.get(name).cr(torch.from_numpy(x), eps) == want, (
            name, x.shape, eps)


@pytest.mark.parametrize("name", REGRESSION_FIT)
def test_regression_fit_bit_equal_on_ragged_miranda(name):
    """The ragged miranda slice, where the library pinv and matmul of
    earlier versions moved 9 residual and 3 plane codes."""
    mir = _slice("miranda-vx", (100, 200))
    eps = 1e-3 * float(np.ptp(mir))
    jcodes, jaux = JC.get(name).encode(jnp.asarray(mir), eps)
    tcodes, taux = TC.get(name).encode(torch.from_numpy(mir), eps)
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(taux["coef_codes"].numpy(),
                                  np.asarray(jaux["coef_codes"]))
    assert (TC.get(name).cr(torch.from_numpy(mir), eps)
            == JC.get(name).cr(jnp.asarray(mir), eps))


@pytest.mark.parametrize("ndim", [2, 3])
def test_design_pinv_is_the_reference_pinv(ndim):
    from repro.compressors import sz as JSZ
    want = np.asarray(jnp.linalg.pinv(JSZ._block_coords(6, ndim)))
    got = TSZ._design_pinv(6, ndim, torch.device("cpu")).numpy()
    assert got.shape == want.shape == (ndim + 1, 6 ** ndim)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("counts", [tuple(range(1, 17)), (64,), (90000,)],
                         ids=["1-16", "64", "90000"])
def test_plane_fit_bit_equal(ndim, counts):
    """``y @ pinv.T`` in XLA's order at every block count: the FMA chain
    below ``DOT_CHAIN_MAX_BLOCKS``, four accumulators above."""
    from repro.compressors import sz as JSZ
    rng = np.random.default_rng(ndim)
    for nb in counts:
        y = (rng.standard_normal((nb,) + (6,) * ndim)
             * 10.0 ** rng.uniform(-3, 3, (nb,) + (1,) * ndim)).astype(np.float32)
        want = np.asarray(JSZ._fit_planes(jnp.asarray(y)))
        got = TSZ._fit_planes(torch.from_numpy(y)).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32),
                                      err_msg=f"{nb} blocks")


@pytest.mark.parametrize("name", JC.STUDY_2D)
def test_error_bound_held(name, cases):
    for x, eps in cases:
        if x.ndim == 3 and not TC.get(name).supports_3d:
            continue
        xt = torch.from_numpy(x)
        err = TC.get(name).roundtrip_error(xt, eps)
        assert err <= eps + TB.error_bound_slack(xt), (name, x.shape, eps)
    assert TB.error_bound_slack(xt) == JB.error_bound_slack(jnp.asarray(x))


@pytest.mark.parametrize("name", BIT_EQUAL)
def test_decode_bit_equal(name, cases):
    x, eps = cases[0]
    jc = JC.get(name)
    tc = TC.get(name)
    jcodes, jaux = jc.encode(jnp.asarray(x), eps)
    tcodes, taux = tc.encode(torch.from_numpy(x), eps)
    want = np.asarray(jc.decode(jcodes, jaux, eps))
    got = tc.decode(tcodes, taux, eps).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_sz2_regression_fraction_and_registry():
    x = _slice("hurricane-u", (96, 96))
    for eps in (1e-3, 1e-1):
        np.testing.assert_allclose(
            TC.get("sz2").regression_fraction(torch.from_numpy(x), eps),
            JC.get("sz2").regression_fraction(jnp.asarray(x), eps), atol=0.02)
    assert TC.STUDY_2D == JC.STUDY_2D and TC.STUDY_3D == JC.STUDY_3D
    assert TC.names() == JC.names()
    assert not TC.get("sz3-interp").supports_3d


# ------------------------------------------------- the reference's log2/exp2
def _powers_near(ks, ulps=(-2, -1, 0, 1, 2)):
    """2^k and its float32 neighbours, 1 and 2 ulps either side."""
    base = np.ldexp(np.float32(1), np.asarray(ks)).astype(np.float32)
    out = []
    for d in ulps:
        v = base.copy()
        for _ in range(abs(d)):
            v = np.nextafter(v, np.float32(np.inf if d > 0 else 0))
        out.append(v)
    return np.concatenate(out)


def test_log2_bit_equal_on_sampled_floats():
    lo = np.float32(2.0 ** -40).view(np.uint32)
    hi = np.float32(2.0 ** 40).view(np.uint32)
    x = np.arange(lo, hi, 997, dtype=np.uint32).view(np.float32)
    # normal floats only: XLA on the CPU reads a subnormal as zero
    x = np.concatenate([x, _powers_near(range(-125, 128))])
    want = np.asarray(jnp.log2(jnp.asarray(x)))
    got = refmath.log2_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_log2_bit_equal_near_every_power_of_two():
    """Every float32 within 2^13 ulps of 2^k, k in [-40, 40] (ZFP's block
    maxima; departures counted in [2^-40, 2^40]), and every magnitude whose ``mag + 1`` is within 2^-10 of a
    power of two, mag in [0, 2^28] (the size model's bit length).  Away
    from those windows log2 is over 7e-4 from an integer, hundreds of
    ulps of the result, so the ceilings counted here are all there are
    in either range; every departure lies within 20 ulps of 2^k."""
    w = 1 << 13
    base = np.ldexp(np.float32(1), np.arange(-40, 41)).astype(np.float32)
    offs = np.arange(-w, w + 1)
    a = ((base.view(np.int32)[:, None] + offs).reshape(-1)
         .astype(np.int32).view(np.float32))
    want = np.asarray(jnp.log2(jnp.asarray(a)))
    got = refmath.log2_f32(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    off = np.ceil(want) != np.ceil(np.log2(a.astype(np.float64)))
    inside = (a >= base[0]) & (a <= base[-1])
    assert np.count_nonzero(off & inside) == 404
    assert np.abs(np.tile(offs, base.size)[off]).max() <= 20
    assert np.count_nonzero(off.reshape(base.size, -1)[:, w]) == 6

    wins = [np.arange(0, 1 << 13)] + [
        np.arange((1 << k) - (1 << (k - 10)) - 1,
                  min((1 << k) + (1 << (k - 10)), 1 << 28) + 1)
        for k in range(13, 29)]
    mag = np.unique(np.concatenate(wins)).astype(np.int32)
    v = jnp.asarray(mag).astype(jnp.float32) + 1.0
    want = np.asarray(jnp.log2(v))
    got = refmath.log2_f32(torch.from_numpy(mag).to(torch.float32) + 1.0)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    exact = np.ceil(np.log2(np.asarray(v).astype(np.float64)))
    assert np.count_nonzero(np.ceil(want) != exact) == 140


def test_ceil_log2_departs_from_exact_at_pinned_powers():
    k = np.arange(-100, 100)
    x = np.ldexp(np.float32(1), k).astype(np.float32)
    ref = np.ceil(np.asarray(jnp.log2(jnp.asarray(x)))).astype(np.int32)
    port = refmath.ceil_log2(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(port, ref)
    # the exact exponent is k; the reference's rule gives k + 1 here
    off = sorted(int(v) for v in k[port != k])
    assert off == [-98, -93, -62, -60, -57, -54, -52, -49, -31, -30, -27,
                   -26, -15, -13]
    assert np.all(port - k >= 0) and np.all(port - k <= 1)


def test_exp2_bit_equal_at_integer_exponents():
    k = np.arange(-125, 151).astype(np.float32)
    want = np.asarray(jnp.exp2(jnp.asarray(k)))
    got = refmath.exp2_f32(torch.from_numpy(k)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    exact = np.ldexp(np.float64(1), k.astype(int))
    inside = k <= 127
    # XLA's exp2(k) misses 2^k at most integer k (up to ~30 ulp)
    assert np.count_nonzero(got[inside] != exact[inside]) > 100
    np.testing.assert_allclose(got[inside], exact[inside], rtol=5e-6)


@pytest.mark.parametrize("lo, hi", [(-40.0, 0.0), (-150.0, -120.0),
                                     (-126.0, 130.0)])
def test_exp2_bit_equal_on_sampled_reals(lo, hi):
    """TTHRESH's decode takes exp2 of non-integer exponents; the subnormal
    end is flushed and the top overflows as in XLA."""
    x = np.random.default_rng(int(-lo)).uniform(lo, hi, 200000).astype(np.float32)
    want = np.asarray(jnp.exp2(jnp.asarray(x)))
    got = refmath.exp2_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_log2_of_zero_and_subnormals_is_minus_inf():
    x = np.array([0.0, -0.0, 1e-45, 1e-40, 1.1e-38, 2.0 ** -126, 1.2e-38,
                  1e-30], np.float32)
    want = np.asarray(jnp.log2(jnp.asarray(x)))
    got = refmath.log2_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert np.isneginf(got[:5]).all() and np.isfinite(got[5:]).all()


@pytest.mark.parametrize(
    "lengths", [tuple(range(0, 20)) + (31, 32, 33, 255, 256, 257),
                (4097, 100000, 1000003)], ids=["short", "long"])
def test_cumsum_f32_is_xla_cpu_cumsum(lengths):
    rng = np.random.default_rng(len(lengths))
    for n in lengths:
        v = (rng.random(n) ** 4 * rng.choice([1.0, 1e-3, 1e3], n)).astype(np.float32)
        want = np.asarray(jnp.cumsum(jnp.asarray(v)))
        got = refmath.cumsum_f32(torch.from_numpy(v)).numpy()
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32),
                                      err_msg=f"length {n}")


def test_zfp_exponent_and_bit_length_rule_on_planted_powers():
    """Block maxima planted at and next to powers of two: the exponents
    and the size model follow the reference, not the exact ceiling."""
    rng = np.random.default_rng(3)
    ks = np.arange(-40, 41)
    tops = _powers_near(ks)                                  # 405 maxima
    blocks = (rng.random((tops.size, 16)) - 0.5) * tops[:, None] * 0.9
    blocks[np.arange(tops.size), rng.integers(0, 16, tops.size)] = \
        tops * np.where(rng.random(tops.size) < 0.5, -1, 1)
    nb = 28 * 15                                             # >= 405 blocks
    blocks = np.concatenate([blocks, np.ones((nb - tops.size, 16))])
    x = np.ascontiguousarray(blocks.astype(np.float32).reshape(28, 15, 4, 4)
                             .transpose(0, 2, 1, 3).reshape(112, 60))
    jq, je, _ = JZ.zfp_transform(jnp.asarray(x))
    tq, te, _ = TZ.zfp_transform(torch.from_numpy(x))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    amax = np.abs(blocks[:tops.size]).max(axis=1).astype(np.float64)
    exact = np.ceil(np.log2(amax)).astype(np.int32)
    assert np.count_nonzero(te.numpy()[:tops.size] != exact) > 0
    for eps in (1e-3, 1e-6):
        assert TZ.zfp_size_bits(tq, te, eps) == \
            int(JZ.zfp_size_bits(jq, je, eps))
    # bit lengths ceil(log2(mag + 1)) where XLA's log2 misses the exact one
    mag = np.array([2097152, 2097153, 4194304, 16777218, 16777219, 16777220,
                    33554435, 33554436, 1000, 65535], np.int32)
    v = jnp.asarray(mag).astype(jnp.float32) + 1.0
    ref_len = np.ceil(np.asarray(jnp.log2(v)))
    port_len = torch.ceil(refmath.log2_f32(
        torch.from_numpy(mag).to(torch.float32) + 1.0)).numpy()
    np.testing.assert_array_equal(port_len, ref_len)
    exact_len = np.ceil(np.log2(mag.astype(np.float64) + 1.0))
    assert np.count_nonzero(port_len[:8] != exact_len[:8]) == 8
    assert np.array_equal(port_len[8:], exact_len[8:])


# ------------------------------------------------- zfp's float32 size total
@pytest.mark.parametrize("n", [1, 7, 32, 33, 63, 1000, 1025, 32 * 32 + 1,
                               50625, 202500, 202501])
def test_sum_f32_is_xla_cpu_sum(n):
    """Random floats of mixed magnitude expose any other order: the
    port's float32 sum equals ``jnp.sum``'s bits at windows' edges, odd
    and non-power-of-two lengths and the block counts of 900^2 and
    1800^2 slices."""
    rng = np.random.default_rng(n)
    for _ in range(3):
        v = (rng.standard_normal(n)
             * 10.0 ** rng.integers(-3, 4, n)).astype(np.float32)
        want = np.asarray(jnp.sum(jnp.asarray(v)))
        got = np.float32(refmath.sum_f32(torch.from_numpy(v)))
        assert got.view(np.int32) == want.view(np.int32)


@pytest.fixture(scope="module")
def cesm_1800():
    """A full cesm-cloud slice (202 500 blocks, 1.7e7 to 4.5e7 bits
    over the chip grid) transformed by both packages."""
    x = np.array(JS.field_slices("cesm-cloud", count=1, n=1800, seed=0)[0])
    jq, je, _ = JZ.zfp_transform(jnp.asarray(x))
    tq, te, _ = TZ.zfp_transform(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    return x, (jq, je), (tq, te)


@pytest.mark.parametrize("eps", CESM_EBS)
def test_zfp_size_total_above_2_24_bits(eps, cesm_1800):
    """Above 2^24 bits the reference's float32 total rounds; the port
    totals in the same order and gives the same bits and bytes.  At
    3.16e-6 an exact integer sum is one bit above it, a byte more."""
    x, (jq, je), (tq, te) = cesm_1800
    jt, tt = JZ.zfp_truncate(jq, je, eps), TZ.zfp_truncate(tq, te, eps)
    want = float(JZ.zfp_size_bits(jt, je, eps))
    got = TZ.zfp_size_bits(tt, te, eps)
    assert got == want and want > 2 ** 24
    assert TC.get("zfp").size_bytes(tt, {"e": te}, eps) == \
        JC.get("zfp").size_bytes(jt, {"e": je}, eps)
    if eps == CESM_EBS[0]:
        assert TC.get("zfp").cr(torch.from_numpy(x), eps) == \
            JC.get("zfp").cr(jnp.asarray(x), eps)
        k = torch.clamp(TZ._cutoff_plane(te, eps, 2), min=0)[:, None, None]
        bitlen = torch.ceil(refmath.log2_f32(tt.abs().to(torch.float32) + 1.0))
        kept = torch.clamp(torch.where(tt != 0, bitlen, 0.0) - k, min=0.0)
        exact = int((kept + (kept > 0)).to(torch.int64).sum()) + 16 * te.numel()
        assert (exact, -(-exact // 8)) == (int(want) + 1, -(-int(want) // 8) + 1)


@pytest.mark.parametrize("shape", [(4, 4), (4, 1800), (1800, 4),
                                   (4 * 33, 4 * 65), (4 * 333, 4 * 555)])
def test_zfp_size_total_on_block_grids(shape):
    """One block, 1-row and 1-column block grids, odd block counts: the
    size, the bytes and the CR follow the reference's float32 total."""
    x = _slice("miranda-vx", shape, seed=4)
    rng = float(np.ptp(x))
    jq, je, _ = JZ.zfp_transform(jnp.asarray(x))
    tq, te, _ = TZ.zfp_transform(torch.from_numpy(x))
    for rel in (1e-6, 1e-3):
        eps = rel * rng
        jt, tt = JZ.zfp_truncate(jq, je, eps), TZ.zfp_truncate(tq, te, eps)
        assert TZ.zfp_size_bits(tt, te, eps) == float(
            JZ.zfp_size_bits(jt, je, eps))
        assert TC.get("zfp").cr(torch.from_numpy(x), eps) == \
            JC.get("zfp").cr(jnp.asarray(x), eps)


def test_zfp_size_total_on_volumes():
    """3-D: a volume through both transforms, and 3-D coefficient
    blocks (an odd count, 2.2e7 and 2.9e7 bits) straight into the size
    model."""
    vol = np.array(JS.volume("miranda-vx", shape=(12, 40, 44)))
    for eps in (1e-5, 1e-3):
        assert TC.get("zfp").cr(torch.from_numpy(vol), eps) == \
            JC.get("zfp").cr(jnp.asarray(vol), eps)
    rng = np.random.default_rng(12)
    nb = 40001
    q = (rng.integers(-2 ** 20, 2 ** 20, (nb, 4, 4, 4))
         >> rng.integers(0, 20, (nb, 1, 1, 1))).astype(np.int32)
    e = rng.integers(-3, 4, nb).astype(np.int32)
    for eps in (1e-7, 1e-5):
        want = float(JZ.zfp_size_bits(jnp.asarray(q), jnp.asarray(e), eps))
        got = TZ.zfp_size_bits(torch.from_numpy(q), torch.from_numpy(e), eps)
        assert got == want and want > 2 ** 24
