"""The port's kernel modules against the reference's Pallas kernels.

Inputs are made with numpy from a seed and handed to both stacks; the
reference runs its kernels in interpret mode on the CPU, the port its
plain versions (the route a CPU tensor takes).  The CUDA kernels
themselves are held against those plain versions on the card by the
``cuda``-marked test at the end and by ``chip_smoke.py``.  Lorenzo
codes and ZFP coefficients and exponents are bit-equal, ZFP also on
block maxima planted at and next to powers of two, where the
reference's float32 ``log2`` departs from the exact exponent.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro_torch.kernels.gram import ops as tgram  # noqa: E402
from repro_torch.kernels.lorenzo import ops as tlor  # noqa: E402
from repro_torch.kernels.lorenzo import ref as tlor_ref  # noqa: E402
from repro_torch.kernels.qent import ops as tqent  # noqa: E402
from repro_torch.kernels.qent import ref as tqent_ref  # noqa: E402
from repro_torch.kernels.quality import ops as tqual  # noqa: E402
from repro_torch.kernels.quality import ref as tqual_ref  # noqa: E402
from repro_torch.kernels.zfp_block import ops as tzfp  # noqa: E402
from repro_torch.kernels.zfp_block import ref as tzfp_ref  # noqa: E402


def _field(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal(shape), axis=-1) * scale
    return np.ascontiguousarray(x, dtype=np.float32)


# ---------------------------------------------------------------------- gram
_GRAM_SHAPES = [(3, 64, 64), (2, 130, 70), (3, 70, 130), (1, 100, 97)]
_GRAM_CASES = [pytest.param(s, t, id=f"{t}-shape{i}")
               for t in (True, False) for i, s in enumerate(_GRAM_SHAPES)] + [
    # a volume unfolding's X X^T (a contraction of three CUDA-kernel
    # chunks, summed by its second pass) and a ragged edge both ways
    pytest.param((2, 16, 9000), False, id="False-tall_skinny"),
    pytest.param((1, 257, 129), True, id="True-ragged"),
    pytest.param((1, 257, 129), False, id="False-ragged"),
]


@pytest.mark.parametrize("shape, transpose", _GRAM_CASES)
def test_gram_batched_matches_reference(shape, transpose):
    from repro.kernels.gram import ops as jgram
    x = _field(1, shape)
    want = np.asarray(jgram.gram_batched(jnp.asarray(x), transpose=transpose))
    got = tgram.gram_batched(torch.from_numpy(x), transpose).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-3)


@pytest.mark.parametrize("m, n, transpose, chunks", [
    (1800, 1800, True, 1), (1200, 1200, True, 1), (1028, 1028, True, 1),
    (4096, 64, True, 1), (4097, 64, True, 2), (16, 9000, False, 3),
    (256, 147456, False, 36), (384, 98304, False, 24)])
def test_gram_chunk_rule_depends_on_the_slice_only(m, n, transpose, chunks):
    """The kernel's contraction chunks are a function of the slice's
    (N, T) alone: the same for any batch, every slice edge up to 1800
    unsplit, a volume unfolding cut into 4096-long chunks."""
    plans = {tgram.launch_plan((k, m, n), transpose) for k in (1, 5, 12, 40)}
    assert plans == {((n, m) if transpose else (m, n)) + (chunks,)}
    assert tgram.contraction_chunks(plans.pop()[1]) == chunks


def test_gram_plain_version_flushes_subnormal_products():
    """The plain version reads subnormal products as zeros, as XLA's CPU
    dot does: a slice below 2^-63 has a zero Gram, and a column of
    ordinary values keeps its (normal) products with the tiny ones."""
    from repro.kernels.gram import ops as jgram
    rng = np.random.default_rng(4)
    tiny = (rng.standard_normal((2, 40, 48)) * 2.0 ** -66).astype(np.float32)
    tiny[1, :, 0] = 1.0 + rng.standard_normal(40).astype(np.float32)
    for tr in (True, False):
        want = np.asarray(jgram.gram_batched(jnp.asarray(tiny), transpose=tr))
        got = tgram.gram_batched(torch.from_numpy(tiny), tr).numpy()
        assert not got[0].any() and not want[0].any()
        np.testing.assert_array_equal(got == 0, want == 0)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-3)


def test_gram_unbatched_is_k1_case():
    from repro.kernels.gram import ops as jgram
    x = _field(2, (90, 120))
    for tr in (True, False):
        want = np.asarray(jgram.gram(jnp.asarray(x), transpose=tr))
        got = tgram.gram(torch.from_numpy(x), tr).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-3)


# ---------------------------------------------------------------------- qent
def _qent_inputs(n):
    x = _field(3, (3, n), scale=0.05)
    # a saturating (value, eps) pair at both ends of the int32 code range
    x[0, 5], x[1, 7] = 3.0e30, -3.0e30
    epss = np.array([1e-3, 1e-2, 7.5e-2], np.float32)
    return x, epss


@pytest.mark.parametrize("n, kind", [
    pytest.param(2048, "plain", id="2048"),
    pytest.param(4096, "plain", id="4096"),
    # half of every slice exact zeros: one hot bin (cesm-cloud's clear sky)
    pytest.param(4096, "hot_bin", id="hot_bin"),
    pytest.param(4096, "one_eps", id="one_eps"),
    # not a power of two: the general positive remainder
    pytest.param(4096, "bins_3000", id="bins_3000"),
])
def test_qent_histograms_bit_equal(n, kind):
    from repro.kernels.qent import qent as jqent
    x, epss = _qent_inputs(n)
    bins = 3000 if kind == "bins_3000" else 4096
    if kind == "hot_bin":
        x[:, : n // 2] = 0.0
    if kind == "one_eps":
        epss = epss[1:2]
    want = np.asarray(jqent.qent_histogram_sweep(
        jnp.asarray(x), jnp.asarray(epss), tile=2048, bins=bins))
    got = tqent.qent_histogram_sweep(torch.from_numpy(x),
                                     torch.from_numpy(epss), bins).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [5000, 130 * 130])
def test_qent_entropy_sweep_ragged(n):
    from repro.kernels.qent import ops as jqent
    x, epss = _qent_inputs(n)
    want = np.asarray(jqent.quantized_entropy_sweep(
        jnp.asarray(x), jnp.asarray(epss), num_bins=4096))
    got = tqent.quantized_entropy_sweep(torch.from_numpy(x), epss, 4096).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    single = float(tqent.quantized_entropy(torch.from_numpy(x[1]),
                                           float(epss[2]), 4096))
    assert abs(single - float(want[1, 2])) < 1e-4


def test_qent_entropy_matches_exact_bincount():
    x = _field(4, (1, 4000), scale=0.02)
    eps = 1e-2
    codes = np.floor(x.reshape(-1) / np.float32(eps)).astype(np.int64)
    _, counts = np.unique(codes, return_counts=True)
    p = counts / counts.sum()
    expect = float(-(p * np.log2(p)).sum())
    got = float(tqent.quantized_entropy(torch.from_numpy(x), eps, 65536))
    assert abs(got - expect) < 1e-4


def test_qent_rejects_bad_eps():
    with pytest.raises(ValueError):
        tqent.quantized_entropy_sweep(torch.zeros(2, 16), [1e-3, 0.0])


# ------------------------------------------------------------------- quality
def _quality_inputs():
    x = _field(5, (5, 130 * 130), scale=0.3)
    x[2] = 0.1234567                             # zero range, nonzero error
    x[3] = np.round(x[3] * 4) / 4                # exact at eps = 0.25
    x[4] = 0.0                                   # zero range, zero error
    return x, np.array([1e-3, 0.0375, 0.25], np.float32)


def test_quality_sse_bit_equal_to_pallas_kernel():
    from repro.kernels.quality import quality as jq
    x, epss = _quality_inputs()
    n = x.shape[1]
    pad = (-n) % 2048
    xp = np.concatenate([x, np.zeros((x.shape[0], pad), np.float32)], axis=1)
    xb = np.swapaxes(xp.reshape(x.shape[0], -1, 8), 1, 2)
    want = np.asarray(jq.qdq_sse_sweep(jnp.asarray(xb), jnp.asarray(epss)))
    got = tqual.qdq_sse_sweep(torch.from_numpy(x), torch.from_numpy(epss)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("k, n, n_eps", [
    (1, 130 * 70, 3),        # one slice, not a multiple of the tile
    (3, 9101, 3),            # an odd length: slices 1, 2 start unaligned
    (2, 4096 + 5, 11),       # 11 eps: two groups of the CUDA fold
])
def test_quality_sse_ragged_bit_equal_to_pallas_kernel(k, n, n_eps):
    from repro.kernels.quality import quality as jq
    x = _field(11 + k, (k, n), scale=0.3)
    epss = np.geomspace(1e-3, 0.3, n_eps).astype(np.float32)
    pad = (-n) % 2048
    xp = np.concatenate([x, np.zeros((k, pad), np.float32)], axis=1)
    xb = np.swapaxes(xp.reshape(k, -1, 8), 1, 2)
    want = np.asarray(jq.qdq_sse_sweep(jnp.asarray(xb), jnp.asarray(epss)))
    got = tqual.qdq_sse_sweep(torch.from_numpy(x), torch.from_numpy(epss)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("use_kernel", [True, False])
def test_quality_tensor_bit_equal(use_kernel):
    from repro.kernels.quality import ops as jq
    x, epss = _quality_inputs()
    want = np.asarray(jq.quality_sweep(jnp.asarray(x), epss,
                                       use_kernel=use_kernel))
    got = tqual.quality_sweep(torch.from_numpy(x), epss).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # the caps: zero range -> -PSNR_CAP / NRMSE_CAP, exact -> PSNR_CAP / 0
    assert np.all(got[2, :, 0] == -tqual_ref.PSNR_CAP)
    assert np.all(got[2, :, 1] == np.float32(tqual_ref.NRMSE_CAP))
    assert got[3, 2, 0] == tqual_ref.PSNR_CAP and got[3, 2, 1] == 0.0
    assert np.all(got[4, :, 0] == tqual_ref.PSNR_CAP)
    assert np.all(np.isfinite(got))


def test_det_log10_bit_equal():
    import jax
    from repro.kernels.quality import ref as jref
    # normal float32 inputs only: XLA on the CPU flushes subnormals to
    # zero (-> -1e4) where PyTorch and the card keep them
    rng = np.random.default_rng(6)
    v = (np.abs(rng.standard_normal(1 << 16)) + 0.01) \
        * 10.0 ** rng.integers(-35, 35, 1 << 16)
    v = v.astype(np.float32)
    v[:4] = [0.0, -1.0, 1.0, 2.0 ** -110]
    assert np.all((v <= 0) | (v >= np.finfo(np.float32).tiny))
    want = np.asarray(jax.jit(jref.det_log10)(v))
    got = tqual_ref.det_log10(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_fma32_rounds_once():
    # a*b = 2^-24 (1 - 2^-46): the float64 sum with c = 1 + 2^-23 lands
    # exactly on a float32 midpoint; the exact value is just below it
    a = np.float32(2.0 ** -24 * (1 + 2.0 ** -23))
    b = np.float32(1 - 2.0 ** -23)
    c = np.float32(1 + 2.0 ** -23)
    t = lambda v: torch.tensor([v], dtype=torch.float32)  # noqa: E731
    naive = np.float32(np.float64(a) * np.float64(b) + np.float64(c))
    got = tqual_ref.fma32(t(a), t(b), t(c)).numpy()[0]
    assert got == c and naive != c
    got_neg = tqual_ref.fma32(t(-a), t(b), t(-c)).numpy()[0]
    assert got_neg == -c


# ------------------------------------------------------------------ lorenzo
SHAPES_2D = [(64, 64), (100, 200), (130, 70), (256, 384)]


@pytest.mark.parametrize("shape", SHAPES_2D)
def test_lorenzo2d_bit_equal_to_pallas_kernel(shape):
    from repro.kernels.lorenzo import ops as jlor
    x = _field(7, shape)
    for eps in (3.7e-4, 1e-3, 0.05):
        want = np.asarray(jlor.lorenzo2d(jnp.asarray(x), eps))
        got = tlor.lorenzo2d(torch.from_numpy(x), eps).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            tlor_ref.lorenzo2d(torch.from_numpy(x), eps).numpy(), want)


@pytest.mark.parametrize("shape", [(1, 1), (1, 37), (37, 1), (33, 131)])
def test_lorenzo2d_ragged_shapes_bit_equal(shape):
    """One element, one row, one column, and n % 4 != 0 with rows that
    are not a multiple of the CUDA kernel's strip: its scalar edge path."""
    from repro.kernels.lorenzo import ops as jlor
    x = _field(13, shape, scale=0.05)
    for eps in (3.7e-4, 0.05):
        want = np.asarray(jlor.lorenzo2d(jnp.asarray(x), eps))
        got = tlor.lorenzo2d(torch.from_numpy(x), eps).numpy()
        np.testing.assert_array_equal(got, want)


def test_lorenzo2d_rejects_bad_input():
    with pytest.raises(ValueError):
        tlor.lorenzo2d(torch.zeros(2, 3, 4), 1e-3)
    with pytest.raises(ValueError):
        tlor.lorenzo2d(torch.zeros(3, 4), 0.0)


# ---------------------------------------------------------------- zfp_block
def _planted(m, n, seed):
    """Block maxima at 2^k and 1 or 2 ulps either side of it."""
    rng = np.random.default_rng(seed)
    nb = (m // 4) * (n // 4)
    mag = np.ldexp(np.float32(1), rng.integers(-40, 41, nb)).astype(np.float32)
    shift = rng.integers(-2, 3, nb)
    top = mag.copy()
    for step in (1, 2):
        top = np.where(shift >= step, np.nextafter(top, np.float32(np.inf)), top)
        top = np.where(shift <= -step, np.nextafter(top, np.float32(0)), top)
    vals = (rng.random((nb, 16)) - 0.5).astype(np.float32) * mag[:, None]
    vals[np.arange(nb), rng.integers(0, 16, nb)] = top * np.where(
        rng.random(nb) < 0.5, -1, 1).astype(np.float32)
    return np.ascontiguousarray(vals.reshape(m // 4, n // 4, 4, 4)
                                .transpose(0, 2, 1, 3).reshape(m, n))


@pytest.mark.parametrize("shape", SHAPES_2D)
def test_zfp_forward2d_bit_equal_to_pallas_kernel(shape):
    from repro.kernels.zfp_block import ops as jzfp
    m4, n4 = shape[0] - shape[0] % 4, shape[1] - shape[1] % 4
    for x in (_field(8, shape, scale=0.01), _planted(m4, n4, 9)):
        jc, je = jzfp.zfp_forward2d(jnp.asarray(x))
        tc, te = tzfp.zfp_forward2d(torch.from_numpy(x))
        assert tc.dtype == te.dtype == torch.int32
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))


def test_zfp_ref_is_the_compressor_transform():
    from repro.kernels.zfp_block import ref as jref
    x = _planted(64, 96, 10)
    jc, je = jref.zfp_forward2d(jnp.asarray(x))
    tc, te = tzfp_ref.zfp_forward2d(torch.from_numpy(x))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    with pytest.raises(ValueError):
        tzfp.zfp_forward2d(torch.zeros(4, 4, 4))


@pytest.mark.parametrize("sms", [1, 7, 132, 264])
@pytest.mark.parametrize("shape", [(4, 4), (4, 1800), (1800, 4), (1028, 1028),
                                   (1800, 1800), (1032, 2052)])
def test_zfp_launch_plan_covers_every_block_once(shape, sms):
    """The grid the wrapper launches ZFP with: at most CTAS_PER_SM CTAs
    an SM, none without a block, and the kernel's grid-stride walk
    (thread t takes blocks t, t + T, ... below the block count) takes
    every 4x4 block of the slice exactly once, no block out of range,
    neighbouring threads on neighbouring blocks."""
    m, n = shape
    nblocks = (m // 4) * (n // 4)
    ctas, steps = tzfp.launch_plan(m, n, sms)
    assert 1 <= ctas <= sms * tzfp.CTAS_PER_SM
    assert (ctas - 1) * tzfp.THREADS < nblocks       # the last CTA has work
    threads = ctas * tzfp.THREADS
    walk = (np.arange(threads)[:, None]
            + threads * np.arange(steps)[None, :])    # (thread, step)
    walk = np.where(walk < nblocks, walk, -1)
    taken = walk[walk >= 0]
    assert taken.max() < nblocks
    np.testing.assert_array_equal(np.sort(taken), np.arange(nblocks))
    assert np.all(np.diff(walk[:, 0][walk[:, 0] >= 0]) == 1)
    if ctas < sms * tzfp.CTAS_PER_SM:                 # one wave, one block
        assert steps == 1


# ------------------------------------------------------------------ routing
@pytest.mark.parametrize("fn, args", [
    (tgram.gram_batched, (torch.zeros(1, 4, 4, dtype=torch.float64),)),
    (tqent.qent_histogram_sweep, (torch.zeros(2, 8), torch.tensor([0.5]))),
    (tqual.qdq_sse_sweep, (torch.zeros(2, 8), torch.tensor([0.5]))),
    (tlor.lorenzo2d, (torch.zeros(5, 7), 0.5)),
    (tzfp.zfp_forward2d, (torch.zeros(5, 7),)),
])
def test_wrappers_take_plain_version_on_cpu(fn, args):
    before = fn.launches
    shapes = dict(getattr(fn, "by_shape", {}))
    out = fn(*args)
    out = out[0] if isinstance(out, tuple) else out
    assert out.device.type == "cpu" and fn.launches == before
    assert dict(getattr(fn, "by_shape", {})) == shapes


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1028, 1028), (1800, 1800), (1030, 1799)])
def test_cuda_zfp_planted_powers_at_main_path_shapes(shape):
    """The ZFP kernel equals its plain version on block maxima planted at
    and next to powers of two at Fig 5's and the main path's slice
    edges and at an odd shape the wrapper edge-pads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ only")
    m, n = shape
    x = torch.from_numpy(_planted(m + (-m) % 4, n + (-n) % 4, 12))[:m, :n]
    coef, exps = tzfp.zfp_forward2d(x.cuda())
    coef_p, exps_p = tzfp.zfp_forward2d(x)
    assert torch.equal(coef.cpu(), coef_p)
    assert torch.equal(exps.cpu(), exps_p)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["gram", "qent", "quality", "lorenzo",
                                    "zfp"])
def test_cuda_kernel_matches_plain_version(kernel):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ only")
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand((3, 130, 70), generator=g, device="cuda") * 2 - 0.5
    epss = torch.tensor([1e-3, 1e-2, 0.1], device="cuda")
    if kernel == "gram":
        # the last input's contraction is three chunks (two passes)
        vol = torch.rand((2, 16, 9000), generator=g, device="cuda") - 0.3
        for inp in (x, x[:1, :129, :69].contiguous(), vol):
            for tr in (True, False):
                got = tgram.gram_batched(inp, tr)
                want = tgram.gram_batched(inp.cpu(), tr)
                torch.testing.assert_close(got.cpu(), want, rtol=2e-5,
                                           atol=2e-3)
                assert torch.equal(got, tgram.gram_batched(inp, tr))
    elif kernel == "qent":
        flat = x.reshape(3, -1)
        hot = flat.clone()
        hot[:, : hot.shape[1] // 2] = 0.0
        for inp, e, bins in ((flat, epss, 65536), (hot, epss, 65536),
                             (flat, epss[1:], 65536), (flat, epss, 3000),
                             (hot, epss, 4096)):
            got = tqent.qent_histogram_sweep(inp, e, bins)
            assert torch.equal(got, tqent_ref.qent_histogram_sweep(inp, e, bins))
    elif kernel == "quality":
        flat = x.reshape(3, -1)
        # a whole tile multiple, a ragged length with unaligned slices,
        # and 11 eps (two groups of the fold)
        more = torch.cat([epss, epss * 0.37, epss[:2] * 5.0])
        for inp, e in ((flat, epss), (flat.reshape(-1)[:3 * 9101].view(3, 9101),
                                      epss), (flat, more)):
            got = tqual.qdq_sse_sweep(inp, e)
            assert torch.equal(got, tqual_ref.sse_sweep(inp, e))
    elif kernel == "lorenzo":
        flat = x.reshape(-1)
        ragged = [flat[:a * b].view(a, b) for a, b in
                  ((1, 1), (1, 37), (37, 1), (33, 131), (33, 132))]
        for inp in [x[0], flat[1:1 + 130 * 68].view(130, 68)] + ragged:
            for eps in (1e-3, 3.7e-4):
                got = tlor.lorenzo2d(inp, eps)
                assert torch.equal(got, tlor_ref.lorenzo2d(inp, eps))
                assert torch.equal(got.cpu(), tlor.lorenzo2d(inp.cpu(), eps))
    else:
        planted = torch.from_numpy(_planted(128, 68, 1)).cuda()
        for inp in (x[0] * 1e-3, x[1, :129, :69], planted):
            coef, exps = tzfp.zfp_forward2d(inp)
            coef_p, exps_p = tzfp.zfp_forward2d(inp.cpu())
            assert torch.equal(coef.cpu(), coef_p)
            assert torch.equal(exps.cpu(), exps_p)
