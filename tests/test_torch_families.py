"""The port's moe and vlm families (``repro_torch.models.moe``, M-RoPE in
``models.layers`` and ``models.causal_lm``) against the reference on
the CPU, at the smoke configs of phi3.5-moe-42b-a6.6b and qwen2-vl-72b.

Inputs are numpy arrays made from a seed; the reference runs as its own
tests run it (``jax.jit`` of its functions) and its parameters are
carried into the port with ``convert`` (norms and QKV biases perturbed
first, so that they are exercised; the router stays float32 in a
bfloat16 model, as the reference makes it).

The reference's functions are compiled with XLA's
``xla_allow_excess_precision`` off (``ref_jit``).  By default XLA's CPU
backend keeps bfloat16 intermediates in float32 inside a fusion (the
residual sum ``x + a`` reaches the next norm unrounded), so a whole
jitted bfloat16 layer computes router logits a few bfloat16 ulps from
its own op-by-op form, and a near-tied (token, choice) pair changes
expert: in the smoke forward 2 of 78 tokens, 1.78 in a logit.  Compiled
without it, the reference's forward equals the port's bit for bit in
that test.  Float32 has no excess precision to drop.

Bounds:

* bit-equal: MoE routing given the same logits -- top-k indices (ties
  planted: ``jax.lax.top_k`` takes the lower index first), the
  reference's ``within_cap`` (G, T, k, E) and dispatch positions, at
  capacities 1, 2 and the formula's -- and the capacity itself; the
  data stream's ``mrope_positions``; parameter tables, counts and
  ``active_params``; converted parameters;
* float32: rtol 1e-5, atol 2e-5 (``moe_ffn``, M-RoPE, logits, caches);
  loss rtol 1e-5; gradients rtol 1e-5 / atol 1e-5 of the leaf's
  largest |value| (``tests/test_torch_train.py``);
* bfloat16: 4 bfloat16 ulps of the largest |value| (``moe_ffn``,
  M-RoPE, logits, caches; ``tests/test_torch_models.py``), loss rtol
  1e-3, gradients 16 ulps of the leaf's largest |value| and no farther
  from the reference's float32 gradient than 1.5x the reference's own
  bfloat16 gradient plus 2 ulps (``tests/test_torch_train.py``);
* the K bias's gradient under three distinct position streams: M-RoPE
  of a bias shared by all keys nearly cancels in the softmax where
  many keys share a stream's position (an image's t), so its entries
  are differences of much larger sums: float32 atol 1e-4 of the leaf's
  largest |value| (1.65e-5 seen), bfloat16 held by the float32
  distance alone (51 ulps of its largest value seen in both packages'
  difference);
* the reference's own properties (``tests/test_models.py``): decode ==
  the full forward within 1e-4 in float32 with no token dropped
  (capacity factor 64), a finite loss with drops (capacity factor 1).

Each side computes its own router logits in the model tests; where
``moe_ffn`` is held alone, the routing of the logits each side computes
is compared too.
"""
import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as RB  # noqa: E402
from repro.data import tokens as RT  # noqa: E402
from repro.models import causal_lm as RCLM  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import moe as RMOE  # noqa: E402
from repro.serve import engine as RE  # noqa: E402
from repro.train import train_step as JTS  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as TB  # noqa: E402
from repro_torch.data import tokens as TT  # noqa: E402
from repro_torch.launch import serve as TLS  # noqa: E402
from repro_torch.launch import train as TLT  # noqa: E402
from repro_torch.models import causal_lm as TCLM  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models.params import (ParamDef, tree_flatten,  # noqa: E402
                                       tree_leaves)
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.train import grad_compress as TGC  # noqa: E402
from repro_torch.train import optimizer as TOPT  # noqa: E402
from repro_torch.train import train_step as TTS  # noqa: E402

MOE_ARCH, VLM_ARCH = "phi3.5-moe-42b-a6.6b", "qwen2-vl-72b"
FAMILIES = [MOE_ARCH, VLM_ARCH]
F32_TOL = dict(rtol=1e-5, atol=2e-5)
BF16_ULPS = 4
LOSS_RTOL = {"float32": 1e-5, "bfloat16": 1e-3}
NO_EXCESS = {"xla_allow_excess_precision": False}


def ref_jit(fn):
    """``jax.jit(fn)`` compiled with XLA's excess precision off (module
    docstring); one compile per argument signature."""
    compiled = {}

    def call(*args):
        key = tuple((np.shape(x), str(np.asarray(x).dtype))
                    for x in jax.tree.leaves(args))
        if key not in compiled:
            compiled[key] = jax.jit(fn).lower(*args).compile(
                compiler_options=NO_EXCESS)
        return compiled[key](*args)

    return call


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy().view(f"i{x.element_size()}")
    x = np.asarray(x)
    return x.view(f"i{x.dtype.itemsize}")


def bf16_ulp(m: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(m, 2.0 ** -126))) - 7)


def assert_close(got, want, dtype: str, what: str = "") -> None:
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, err_msg=what, **F32_TOL)
        return
    tol = BF16_ULPS * bf16_ulp(float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)


def t(x) -> torch.Tensor:
    return convert.array(x, "cpu")


def cfgs(arch: str, dtype: str = "bfloat16", **kw):
    """(port config, reference config) of the smoke model."""
    return (dataclasses.replace(TB.get_smoke(arch), dtype=dtype, **kw),
            dataclasses.replace(RB.get_smoke(arch), dtype=dtype, **kw))


def ref_tree(rcfg, seed: int = 0):
    """The reference's parameters as numpy: bfloat16 leaves in the
    config's dtype, the float32 router kept float32; norms and biases
    perturbed (their inits are constants)."""
    dt = jnp.dtype(rcfg.dtype)
    tree = jax.tree.map(
        lambda a: np.asarray(a.astype(dt) if a.dtype == jnp.bfloat16 else a),
        RM.init_params(rcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    seg = tree["seg0"]
    for k in ("norm1", "norm2"):
        seg[k] = (1 + 0.1 * rng.standard_normal(seg[k].shape)).astype(dt)
    tree["final_norm"] = (1 + 0.1 * rng.standard_normal(
        tree["final_norm"].shape)).astype(dt)
    for k in ("bq", "bk", "bv"):
        if k in seg["attn"]:
            seg["attn"][k] = (0.1 * rng.standard_normal(
                seg["attn"][k].shape)).astype(dt)
    return tree


def tokens(cfg, b: int, s: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def image_then_text(b: int, s: int, grid=(4, 8)) -> np.ndarray:
    """Qwen2-VL's three position streams for an image of ``grid`` patches
    (t fixed, h and w its rows and columns) followed by text (all three
    streams the text's positions, continuing after the image's
    largest): (3, b, s) int32, three distinct streams."""
    gh, gw = grid
    n_img = gh * gw
    img = np.stack([np.zeros(n_img, np.int64),
                    np.repeat(np.arange(gh), gw),
                    np.tile(np.arange(gw), gh)])
    start = int(img.max()) + 1
    text = np.arange(start, start + s - n_img)
    pos = np.concatenate([img, np.stack([text] * 3)], axis=1)[:, :s]
    return np.broadcast_to(pos[:, None, :], (3, b, s)).astype(np.int32).copy()


def with_positions(cfg, batch: dict, distinct: bool) -> dict:
    """The batch with the vlm family's ``mrope_positions``: broadcast
    (the reference's test batches) or ``image_then_text``."""
    if cfg.family != "vlm":
        return batch
    b, s = batch["tokens"].shape
    out = dict(batch)
    out["mrope_positions"] = (image_then_text(b, s) if distinct else
                              np.broadcast_to(np.arange(s, dtype=np.int32),
                                              (3, b, s)).copy())
    return out


def tbatch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


# ---------------------------------------------------------------- tables

@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_param_table_counts_and_active_params(arch, size):
    """Names, shapes and dtypes (the router float32) == the reference's
    ``M.abstract_params`` without allocating, and the counts and
    ``active_params`` equal."""
    get = "get_arch" if size == "full" else "get_smoke"
    cfg, rcfg = getattr(TB, get)(arch), getattr(RB, get)(arch)
    ref = {".".join(str(getattr(k, "key", k)) for k in path): leaf
           for path, leaf in jax.tree_util.tree_flatten_with_path(
               RM.abstract_params(rcfg))[0]}
    got = dict(tree_flatten(TM.param_table(cfg),
                            lambda x: isinstance(x, ParamDef)))
    assert list(got) == list(ref)
    for name, d in got.items():
        assert d.shape == ref[name].shape, name
        assert str(d.dtype).split(".")[-1] == np.dtype(ref[name].dtype).name
    assert TM.count_params(cfg) == RM.count_params(rcfg) == cfg.param_count()
    assert TM.active_params(cfg) == RM.active_params(rcfg)
    if arch == MOE_ARCH:
        assert got["seg0.moe.router"].dtype == torch.float32
        if size == "full":
            assert TM.count_params(cfg) == 41_874_100_224
            assert TM.active_params(cfg) == 6_641_946_624
    elif size == "full":
        assert TM.count_params(cfg) == TM.active_params(cfg) == 72_706_203_648


# ---------------------------------------------------------------- M-RoPE

def test_mrope_section_ids_follow_jnp_repeat():
    for sections, half in (((16, 24, 24), 64), ((2, 3, 3), 8),
                           ((2, 3, 3), 10), ((2, 3, 3), 6)):
        want = np.asarray(jnp.repeat(jnp.arange(3), jnp.asarray(sections),
                                     total_repeat_length=half))
        assert TL.mrope_section_ids(sections, half) == want.tolist()


@pytest.mark.parametrize("sections,hd", [((2, 3, 3), 16), ((16, 24, 24), 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mrope_with_three_distinct_streams(dtype, sections, hd):
    """A 4 x 8 image grid's positions then text (three different
    streams), and broadcast positions, where M-RoPE is plain RoPE."""
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 40, 4, hd)).astype(jnp.dtype(dtype))
    pos3 = image_then_text(2, 40)
    assert len({pos3[i].tobytes() for i in range(3)}) == 3
    fn = jax.jit(lambda x, p: RL.apply_mrope(x, p, 1e6, sections))
    got = TL.apply_mrope(t(x), t(pos3), 1e6, sections)
    assert got.dtype == t(x).dtype
    assert_close(got, fn(x, pos3), dtype, "mrope")
    flat = np.broadcast_to(np.arange(40, dtype=np.int32), (3, 1, 40)).copy()
    assert_close(TL.apply_mrope(t(x), t(flat), 1e6, sections),
                 fn(x, flat), dtype, "mrope broadcast")
    assert torch.equal(TL.apply_mrope(t(x), t(flat), 1e6, sections),
                       TL.apply_rope(t(x), t(flat[0]), 1e6))


# ---------------------------------------------------------------- routing

def _ref_route(logits, k: int, capacity: int):
    """The reference's routing lines of ``moe_ffn`` (``moe.py:70-84``) on
    given logits: its ``_top_k_gating``, then the queue positions,
    ``within_cap`` and the dispatch position of each pair."""
    g, tt, e = logits.shape
    weights, idx = RMOE._top_k_gating(logits, k)
    onehot = jax.nn.one_hot(idx, e, dtype=jnp.int32)
    flatoh = onehot.reshape(g, tt * k, e)
    pos_in_expert = (jnp.cumsum(flatoh, axis=1) - flatoh).reshape(g, tt, k, e)
    within_cap = pos_in_expert < capacity
    return weights, idx, within_cap, jnp.sum(pos_in_expert * onehot, axis=-1)


def _tied_logits(g: int, tt: int, e: int, seed: int) -> np.ndarray:
    """bfloat16-valued float32 logits with planted ties: whole rows
    equal, the top two equal, the second and third equal."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((g, tt, e)).astype(jnp.bfloat16).astype(np.float32)
    x[:, 0] = 0.5                                   # every expert tied
    x[:, 1, : e // 2] = 1.0                         # a block of top ties
    order = np.argsort(-x[:, 2], axis=-1)
    for gi in range(g):                             # 2nd == 3rd, 1st apart
        a, b2, c = order[gi, :3]
        x[gi, 2, a] = 3.0
        x[gi, 2, b2] = x[gi, 2, c] = 2.0
    x[:, 3] = np.round(x[:, 3] * 2) / 2             # coarse: many ties
    return x


@pytest.mark.parametrize("capacity", [1, 2, "formula"])
@pytest.mark.parametrize("e,k", [(4, 2), (16, 2), (16, 6)])
def test_routing_bitequal_given_the_same_logits(e, k, capacity):
    """Top-k indices (ties to the lower index), ``within_cap`` (G, T, k,
    E), dispatch positions and the keep mask are the reference's bits on
    the same logits, and the gating weights too (the same float32
    softmax and normalization)."""
    g, tt = 3, 24
    logits = _tied_logits(g, tt, e, seed=e * 10 + k)
    cap = (TMOE.capacity_of(tt, k, e, 1.25) if capacity == "formula"
           else capacity)
    rw, ridx, rwc, rpos = jax.jit(_ref_route, static_argnums=(1, 2))(
        jnp.asarray(logits), k, cap)
    w, idx, pos, keep = TMOE.route(torch.from_numpy(logits), k, cap)
    wc = TMOE.queue_positions(idx, e) < cap
    assert np.array_equal(idx.numpy(), np.asarray(ridx))
    assert np.array_equal(wc.numpy(), np.asarray(rwc))
    assert np.array_equal(pos.numpy(), np.asarray(rpos))
    assert np.array_equal(keep.numpy(), np.asarray(rpos) < cap)
    np.testing.assert_allclose(w.numpy(), np.asarray(rw), rtol=1e-6)
    if capacity == 1:
        assert not keep.all() and keep.any()
    assert idx[:, 0, 0].tolist() == [0] * g           # all tied: 0, 1, ...
    assert idx[:, 0, 1].tolist() == [1] * g


def test_capacity_formula_equals_the_reference():
    """``int(max(k, g k / E cf))`` then ``min(., g)``: decode of 4
    tokens, prefill of 4 x 32 and a 2 x 512 microbatch at 16 experts
    top-2 (2, 20, 160), and smoke sizes."""
    cases = {(4, 2, 16, 1.25): 2, (128, 2, 16, 1.25): 20,
             (1024, 2, 16, 1.25): 160, (64, 2, 4, 1.0): 32,
             (1, 2, 4, 1.25): 1, (8, 2, 4, 64.0): 8}
    for (gs, k, e, cf), want in cases.items():
        ref = min(int(max(k, gs * k / e * cf)), gs)
        assert TMOE.capacity_of(gs, k, e, cf) == ref == want


# ---------------------------------------------------------------- moe_ffn

def _layer_moe(tree, i: int = 0) -> dict:
    return {k: v[i] for k, v in tree["seg0"]["moe"].items()}


MOE_CASES = {
    # name: (b, s, capacity factor, group size)
    "default": (2, 16, 1.25, 4096),
    "drops": (2, 16, 0.5, 4096),
    "groups": (4, 12, 1.0, 8),
    "decode": (4, 1, 1.25, 4096),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_matches_reference(dtype, case):
    """One layer's ``moe_ffn`` on the same converted parameters: the
    output within the dtype's bound, and the routing of the router
    logits each side computes equal (so the bound is not luck)."""
    b, s, cf, gs = MOE_CASES[case]
    cfg, rcfg = cfgs(MOE_ARCH, dtype)
    p = _layer_moe(ref_tree(rcfg, seed=3))
    dt = jnp.dtype(dtype)
    x = np.random.default_rng(4).standard_normal((b, s, cfg.d_model)
                                                 ).astype(dt)
    kw = dict(num_experts=cfg.num_experts, top_k=cfg.experts_per_token,
              capacity_factor=cf, group_size=gs)
    want = ref_jit(functools.partial(RMOE.moe_ffn, **kw))(
        jnp.asarray(x), jax.tree.map(jnp.asarray, p))
    tp = {k: t(v) for k, v in p.items()}
    got = TMOE.moe_ffn(t(x), SimpleNamespace(**tp), **kw)
    assert got.dtype == t(x).dtype
    assert_close(got, want, dtype, case)
    # the logits each side computes route alike
    gsz = min(gs, b * s)
    xt = x.reshape(-1, gsz, cfg.d_model)
    rl = ref_jit(lambda a, r: jnp.einsum("gtd,de->gte", a, r.astype(a.dtype)))(
        xt, p["router"])
    tl = TL.dot(t(xt), tp["router"].to(t(xt).dtype))
    cap = TMOE.capacity_of(gsz, kw["top_k"], kw["num_experts"], cf)
    _, ridx, _, rpos = _ref_route(jnp.asarray(rl), kw["top_k"], cap)
    _, idx, pos, keep = TMOE.route(tl, kw["top_k"], cap)
    assert np.array_equal(idx.numpy(), np.asarray(ridx))
    assert np.array_equal(pos.numpy(), np.asarray(rpos))
    if case == "drops":
        assert not keep.all()


def test_moe_ffn_with_shared_experts_matches_reference():
    """A shared expert (deepseek's option, kept in the table): float32."""
    cfg, rcfg = cfgs(MOE_ARCH, "float32", num_shared_experts=1)
    p = _layer_moe(ref_tree(rcfg, seed=5))
    assert "shared_wg" in p
    x = np.random.default_rng(6).standard_normal((2, 8, cfg.d_model)
                                                 ).astype(np.float32)
    kw = dict(num_experts=cfg.num_experts, top_k=cfg.experts_per_token)
    want = ref_jit(functools.partial(RMOE.moe_ffn, **kw))(
        jnp.asarray(x), jax.tree.map(jnp.asarray, p))
    got = TMOE.moe_ffn(t(x), SimpleNamespace(**{k: t(v) for k, v in
                                                 p.items()}), **kw)
    assert_close(got, want, "float32", "shared")


def test_aux_load_balance_loss_matches_reference():
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((2, 16, 4)).astype(np.float32)
    _, idx = RMOE._top_k_gating(jnp.asarray(logits), 2)
    want = jax.jit(RMOE.aux_load_balance_loss, static_argnums=2)(
        jnp.asarray(logits), idx, 4)
    got = TMOE.aux_load_balance_loss(torch.from_numpy(logits),
                                     torch.from_numpy(np.asarray(idx)).long(),
                                     4)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------- model

@functools.lru_cache(maxsize=None)
def _ref_forward(rcfg):
    return ref_jit(lambda p, tk, mp: RCLM.logits_fn(p, RCLM.forward(
        p, tk, rcfg, remat=False, mrope_positions=mp)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_and_loss_equal_reference(arch, dtype):
    """The whole smoke forward (logits) and the loss on the same
    converted parameters; for vlm with broadcast positions and with
    three distinct streams (which change the logits)."""
    cfg, rcfg = cfgs(arch, dtype)
    tree = ref_tree(rcfg, seed=1)
    rp = jax.tree.map(jnp.asarray, tree)
    model = convert.lm_params(tree, cfg, device="cpu")
    toks = tokens(cfg, 2, 40, seed=2)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    outs = []
    for distinct in ((False, True) if arch == VLM_ARCH else (False,)):
        bt = with_positions(cfg, batch, distinct)
        mp = bt.get("mrope_positions")
        want = _ref_forward(rcfg)(rp, bt["tokens"], mp)
        with torch.inference_mode():
            got = TCLM.logits_fn(model, TCLM.forward(
                model, t(bt["tokens"]), cfg,
                mrope_positions=None if mp is None else t(mp)))
        assert_close(got, want, dtype, f"logits distinct={distinct}")
        wl = ref_jit(lambda p, b: RM.loss_fn(p, b, rcfg))(
            rp, jax.tree.map(jnp.asarray, bt))
        with torch.inference_mode():
            tl = TM.loss_fn(model, tbatch(bt), cfg)
        np.testing.assert_allclose(float(tl), float(wl),
                                   rtol=LOSS_RTOL[dtype])
        outs.append(f32(got))
    if arch == VLM_ARCH:
        assert not np.array_equal(outs[0], outs[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_teacher_forced_decode(arch, dtype):
    """Prefill logits and cache, then 4 decode steps fed the same tokens
    (a decode step routes a group of B tokens, capacity 2)."""
    cfg, rcfg = cfgs(arch, dtype)
    tree = ref_tree(rcfg, seed=2)
    rp = jax.tree.map(jnp.asarray, tree)
    model = convert.lm_params(tree, cfg, device="cpu")
    toks = tokens(cfg, 2, 16, seed=3)
    pre = ref_jit(lambda p, tk: RM.prefill(p, {"tokens": tk}, rcfg, 24))
    dec = ref_jit(lambda p, c, tk, pos: RM.decode_step(p, c, tk, pos, rcfg))
    lr, cr = pre(rp, toks[:, :12])
    with torch.inference_mode():
        lt, ct = TM.prefill(model, {"tokens": t(toks[:, :12])}, cfg, 24)
    for i in range(12, 17):
        what = "prefill" if i == 12 else f"decode {i - 1}"
        assert_close(lt, lr, dtype, f"{what} logits")
        assert_close(ct["seg0"].k, cr["seg0"].k, dtype, f"{what} k")
        assert_close(ct["seg0"].v, cr["seg0"].v, dtype, f"{what} v")
        assert np.array_equal(ct["seg0"].pos.numpy(),
                              np.asarray(cr["seg0"].pos)), what
        if i < 16:
            lr, cr = dec(rp, cr, toks[:, i:i + 1], jnp.int32(i))
            with torch.inference_mode():
                lt, ct = TM.decode_step(model, ct, t(toks[:, i:i + 1]), i,
                                        cfg)


def test_vlm_decode_takes_mrope_positions():
    """A decode step given (3, B, 1) streams == the reference's, and
    differs from the broadcast one when the streams differ."""
    cfg, rcfg = cfgs(VLM_ARCH, "float32")
    tree = ref_tree(rcfg, seed=4)
    rp = jax.tree.map(jnp.asarray, tree)
    model = convert.lm_params(tree, cfg, device="cpu")
    toks = tokens(cfg, 2, 9, seed=5)
    mp = np.asarray([[[8], [8]], [[3], [3]], [[5], [5]]], np.int32)
    _, cr = jax.jit(lambda p, tk: RM.prefill(p, {"tokens": tk}, rcfg, 12))(
        rp, toks[:, :8])
    want, _ = jax.jit(lambda p, c, tk, m: RM.decode_step(
        p, c, tk, jnp.int32(8), rcfg, mrope_positions=m))(
        rp, cr, toks[:, 8:], mp)
    with torch.inference_mode():
        _, ct = TM.prefill(model, {"tokens": t(toks[:, :8])}, cfg, 12)
        got, _ = TM.decode_step(model, ct, t(toks[:, 8:]), 8, cfg,
                                mrope_positions=t(mp))
        _, ct = TM.prefill(model, {"tokens": t(toks[:, :8])}, cfg, 12)
        flat, _ = TM.decode_step(model, ct, t(toks[:, 8:]), 8, cfg)
    assert_close(got, want, "float32", "decode with streams")
    assert not torch.equal(got, flat)


# ------------------------------------- the reference's tests/test_models.py

def _ref_style_batch(cfg, b=2, s=32) -> dict:
    toks = tokens(cfg, b, s, seed=0)
    return with_positions(cfg, {"tokens": toks, "labels": toks}, False)


@pytest.mark.parametrize("arch", FAMILIES)
def test_smoke_forward_and_loss(arch):
    cfg = TB.get_smoke(arch)
    model = TM.init_params(cfg, torch.Generator().manual_seed(0))
    with torch.inference_mode():
        loss = TM.loss_fn(model, tbatch(_ref_style_batch(cfg)), cfg)
    assert loss.shape == () and bool(torch.isfinite(loss)), arch
    assert 1.0 < float(loss) < 20.0, (arch, float(loss))


@pytest.mark.parametrize("arch", FAMILIES)
def test_smoke_train_step(arch):
    """Two microbatches of 2 (vlm: ``mrope_positions`` split with them),
    the gate on; finite metrics, changed parameters, the router's float32
    gradient through ``compress_tree`` and AdamW."""
    cfg = TB.get_smoke(arch)
    state = TTS.init_state(cfg, torch.Generator().manual_seed(0),
                           compress=True)
    before = [x.clone() for x in tree_leaves(state.params)]
    seen = []
    orig = TGC.compress_tree

    def spy(grads, ef, c, inplace=False):
        seen.append(dict(tree_flatten(grads)))
        return orig(grads, ef, c, inplace)

    step = TTS.make_train_step(cfg, microbatches=2,
                               compress=TGC.CompressConfig())
    TGC.compress_tree = spy
    try:
        state2, m = step(state, tbatch(_ref_style_batch(cfg, b=4)))
    finally:
        TGC.compress_tree = orig
    assert bool(torch.isfinite(m["loss"])) and bool(
        torch.isfinite(m["grad_norm"]))
    assert not torch.equal(before[0], tree_leaves(state2.params)[0]), arch
    if arch == MOE_ARCH:
        g = seen[0]["seg0.moe.router"]
        assert g.dtype == torch.float32 and bool(g.abs().sum() > 0)
        p = dict(tree_flatten(state2.params))["seg0.moe.router"]
        assert p.dtype == torch.float32
        old = dict(tree_flatten(state.params))["seg0.moe.router"]
        assert not torch.equal(p, old)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_forward(arch):
    """float32, capacity factor 64 (no token dropped): prefill 15 tokens
    and decode the 16th == the full forward's last logits within 1e-4
    (vlm: broadcast positions, as the reference's test feeds them)."""
    cfg = dataclasses.replace(TB.get_smoke(arch), dtype="float32",
                              capacity_factor=64.0)
    model = TM.init_params(cfg, torch.Generator().manual_seed(0)).float()
    toks = torch.from_numpy(tokens(cfg, 2, 16, seed=9))
    mp3 = (torch.arange(16, dtype=torch.int32).expand(3, 2, 16)
           if cfg.family == "vlm" else None)
    with torch.inference_mode():
        full = TCLM.logits_fn(model, TCLM.forward(model, toks, cfg,
                                                  mrope_positions=mp3))
        _, cache = TM.prefill(model, {"tokens": toks[:, :15]}, cfg, 20)
        mp1 = (torch.full((3, 2, 1), 15, dtype=torch.int32)
               if cfg.family == "vlm" else None)
        lg, _ = TM.decode_step(model, cache, toks[:, 15:16], 15, cfg,
                               mrope_positions=mp1)
    err = float((lg - full[:, 15]).abs().max())
    assert err < 1e-4, (arch, err)


@pytest.mark.parametrize("arch", FAMILIES)
def test_moe_capacity_dropping_bounded(arch):
    """Capacity factor 1.0 in float32: the loss stays finite (the moe
    family drops tokens; the vlm family has no experts and is
    unchanged by the factor)."""
    cfg = dataclasses.replace(TB.get_smoke(arch), dtype="float32",
                              capacity_factor=1.0)
    model = TM.init_params(cfg, torch.Generator().manual_seed(0)).float()
    with torch.inference_mode():
        loss = TM.loss_fn(model, tbatch(_ref_style_batch(cfg)), cfg)
    assert bool(torch.isfinite(loss))
    if arch == MOE_ARCH:
        x = torch.randn(2, 32, cfg.d_model, generator=torch.Generator()
                        .manual_seed(1))
        lp = model.layers[0].moe
        logits = TL.dot(x.reshape(1, 64, -1), lp.router)
        cap = TMOE.capacity_of(64, 2, cfg.num_experts, 1.0)
        *_, keep = TMOE.route(logits, 2, cap)
        assert cap == 32 and not bool(keep.all())         # pairs dropped


# ---------------------------------------------------------------- training

@functools.lru_cache(maxsize=None)
def _ref_grads_fn(rcfg):
    return ref_jit(lambda p, b: JTS._grads(rcfg, p, b, 1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_every_gradient_leaf(arch, dtype):
    """The loss and every gradient leaf against ``jax.jit`` of the
    reference's ``_grads`` (vlm: three distinct position streams);
    float32 rtol 1e-5 / atol 1e-5 of the leaf's max; bfloat16 16 ulps of
    the leaf's max (``tests/test_torch_train.py``).  The router's
    gradient is float32 in both dtypes; in a bfloat16 model it comes
    through the router's bfloat16 cast, so it is held as the bfloat16
    leaves are."""
    cfg, rcfg = cfgs(arch, dtype)
    tree = ref_tree(rcfg, seed=6)
    toks = tokens(cfg, 4, 33, seed=7)
    batch = with_positions(cfg, {"tokens": toks[:, :-1],
                                 "labels": toks[:, 1:]}, True)
    jl, jg = _ref_grads_fn(rcfg)(jax.tree.map(jnp.asarray, tree),
                                 jax.tree.map(jnp.asarray, batch))
    tl, tg = TTS._grads(cfg, convert.lm_tree(tree, "cpu"), tbatch(batch), 1)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL[dtype])
    want = dict(tree_flatten(jax.tree.map(np.asarray, jg)))
    got = dict(tree_flatten(tg))
    assert list(got) == list(want)
    if dtype == "bfloat16":
        r32 = dataclasses.replace(rcfg, dtype="float32")
        _, j32 = _ref_grads_fn(r32)(
            jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree),
            jax.tree.map(jnp.asarray, batch))
        want32 = dict(tree_flatten(jax.tree.map(np.asarray, j32)))
    for k in want:
        assert str(got[k].dtype).split(".")[-1] == want[k].dtype.name, k
        g, w = f32(got[k]), f32(want[k])
        m = float(np.abs(w).max())
        cancels = arch == VLM_ARCH and k == "seg0.attn.bk"
        if dtype == "float32":
            np.testing.assert_allclose(
                g, w, rtol=1e-5, atol=(1e-4 if cancels else 1e-5) * m,
                err_msg=k)
            continue
        ulp = bf16_ulp(m)
        err = float(np.abs(g - w).max())
        assert cancels or err <= 16 * ulp, (k, err, 16 * ulp)
        e_port = float(np.abs(g - want32[k]).max())
        e_ref = float(np.abs(w - want32[k]).max())
        assert e_port <= 1.5 * e_ref + 2 * ulp, (k, e_port, e_ref)
    if arch == MOE_ARCH:
        assert got["seg0.moe.router"].dtype == torch.float32


def test_router_leaf_compress_and_adamw_bitequal():
    """``compress_tree`` and one AdamW step on a bfloat16 moe tree with
    its float32 router leaf: the reference's bits (clip inactive)."""
    from repro.train import grad_compress as JGC
    from repro.train import optimizer as JOPT
    cfg, rcfg = cfgs(MOE_ARCH, "bfloat16")
    tree = ref_tree(rcfg, seed=8)
    toks = tokens(cfg, 4, 33, seed=9)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    _, jg = _ref_grads_fn(rcfg)(jax.tree.map(jnp.asarray, tree),
                                jax.tree.map(jnp.asarray, batch))
    grads = jax.tree.map(np.asarray, jg)
    rng = np.random.default_rng(10)
    res = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 1e-4
                                  ).astype(np.float32), grads)
    cc = JGC.CompressConfig()
    js, je, jc = jax.jit(lambda g, r: JGC.compress_tree(
        g, JGC.EFState(r), cc))(grads, res)
    ts, te, tc = TGC.compress_tree(convert.lm_tree(grads, "cpu"),
                                   TGC.EFState(convert.lm_tree(res, "cpu")),
                                   TGC.CompressConfig())
    for name, got, want in (("sent", ts, js), ("resid", te.residuals,
                                               je.residuals), ("cr", tc, jc)):
        want = dict(tree_flatten(jax.tree.map(np.asarray, want)))
        for k, x in tree_flatten(got):
            assert np.array_equal(bits(x), bits(want[k])), (name, k)
    assert float(dict(tree_flatten(tc))["seg0.moe.router"]) >= cc.gate_ratio
    ocfg = dict(lr=1e-3, grad_clip=1e9)
    jst = JOPT.init(jax.tree.map(jnp.asarray, tree))
    jp, jo, _ = jax.jit(lambda p, g, s: JOPT.apply(
        JOPT.AdamWConfig(**ocfg), p, g, s))(
        jax.tree.map(jnp.asarray, tree), js, jst)
    tp, to, _ = TOPT.apply(TOPT.AdamWConfig(**ocfg),
                           convert.lm_tree(tree, "cpu"),
                           convert.lm_tree(jax.tree.map(np.asarray, js),
                                           "cpu"),
                           TOPT.init(convert.lm_tree(tree, "cpu")))
    for name, got, want in (("params", tp, jp), ("mu", to.mu, jo.mu),
                            ("nu", to.nu, jo.nu)):
        want = dict(tree_flatten(jax.tree.map(np.asarray, want)))
        for k, x in tree_flatten(got):
            assert np.array_equal(bits(x), bits(want[k])), (name, k)


# ---------------------------------------------------------------- convert, data

@pytest.mark.parametrize("arch", FAMILIES)
def test_convert_round_trips(arch):
    """Reference trees (bfloat16 leaves, the float32 router, QKV biases)
    into ``lm_params`` / ``lm_tree`` / ``train_state`` and back to numpy:
    every leaf's dtype and bits kept; the model's modules hold them."""
    cfg, rcfg = cfgs(arch)
    tree = ref_tree(rcfg, seed=11)
    model = convert.lm_params(tree, cfg, device="cpu")
    want = dict(tree_flatten(tree))
    named = dict(model.named_parameters())
    for k, a in want.items():
        parts = k.split(".")
        if parts[0] == "seg0":
            for i in range(cfg.num_layers):
                x = named[".".join(["layers", str(i)] + parts[1:])]
                assert np.array_equal(bits(x), bits(a[i])), (k, i)
        else:
            assert np.array_equal(bits(named[k]), bits(a)), k
    back = dict(tree_flatten(convert.lm_tree(tree, "cpu")))
    for k, a in want.items():
        assert str(back[k].dtype).split(".")[-1] == a.dtype.name, k
        assert np.array_equal(bits(back[k]), bits(a)), k
    rst = JTS.init_state(rcfg, jax.random.PRNGKey(1), compress=True)
    st = convert.train_state(jax.tree.map(np.asarray, rst), "cpu")
    for got, ref in ((st.params, rst.params), (st.opt.mu, rst.opt.mu),
                     (st.ef.residuals, rst.ef.residuals)):
        w = dict(tree_flatten(jax.tree.map(np.asarray, ref)))
        for k, x in tree_flatten(got):
            assert np.array_equal(bits(x), bits(w[k])), k
    if arch == MOE_ARCH:
        assert model.layers[1].moe.router.dtype == torch.float32


def test_token_stream_mrope_positions_equal_reference():
    cfg, rcfg = TB.get_smoke(VLM_ARCH), RB.get_smoke(VLM_ARCH)
    want = np.asarray(RT.make_data_iter(rcfg, 4, 24, seed=3)(2)
                      ["mrope_positions"])
    got = TT.make_data_iter(cfg, 4, 24, seed=3, device="cpu")(2)
    assert got["mrope_positions"].dtype == torch.int32
    assert np.array_equal(got["mrope_positions"].numpy(), want)
    assert "mrope_positions" not in TT.make_data_iter(
        TB.get_smoke(MOE_ARCH), 4, 24, device="cpu")(0)


# ---------------------------------------------------------------- serving

@pytest.mark.parametrize("arch", FAMILIES)
def test_gate_on_a_prefilled_cache_bitequal(arch):
    """The reference's prefilled cache of the family, gated by both
    engines: CRs (the jitted size model), rewritten leaves and
    metering bit-equal."""
    cfg, rcfg = cfgs(arch)
    tree = ref_tree(rcfg, seed=12)
    rp = jax.tree.map(jnp.asarray, tree)
    toks = tokens(cfg, 2, 10, seed=13)
    _, rcache = ref_jit(lambda p, tk: RM.prefill(p, {"tokens": tk}, rcfg,
                                                 16))(rp, toks)
    cache = convert.lm_cache(jax.tree.map(np.asarray, rcache), device="cpu")
    ref = RE.Engine(rcfg, rp, RE.ServeConfig(max_len=16, kv_compress=True))
    eng = TE.Engine(cfg, None, TE.ServeConfig(max_len=16, kv_compress=True))
    want_crs = np.asarray(ref._gate_crs(tuple(jax.tree.leaves(rcache)[:2])))
    got_crs = eng._predict_crs(tree_leaves(cache)[:2])
    assert np.array_equal(got_crs.view(np.uint32), want_crs.view(np.uint32))
    got = tree_leaves(eng._maybe_compress_cache(cache))
    want = jax.tree.leaves(ref._maybe_compress_cache(rcache))
    for g, w in zip(got, want):
        assert np.array_equal(bits(g), bits(w))
    assert (eng.kv_saved_bytes, eng.kv_total_bytes) == \
        (ref.kv_saved_bytes, ref.kv_total_bytes)


@pytest.mark.parametrize("arch", FAMILIES)
def test_launchers_serve_and_train_the_family(arch, tmp_path):
    """``launch.serve`` with the gate, directly and through the service
    (the same ids and metering), and ``launch.train --compress
    --lossy-ckpt`` (the float32 router goes through the lossy
    checkpoint like the other leaves), on the smoke config."""
    base = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "8", "--steps", "4", "--max-len", "16",
            "--kv-compress"]
    a = TLS.main(base)
    b = TLS.main(base + ["--kv-gate-service"])
    assert a["shape"] == [2, 4] and a["ids"] == b["ids"]
    assert a["params"] == TM.count_params(TB.get_smoke(arch))
    assert (a["kv_saved_bytes"], a["kv_total_bytes"]) == \
        (b["kv_saved_bytes"], b["kv_total_bytes"])
    r = TLT.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps",
                  "4", "--batch", "4", "--seq", "32", "--compress",
                  "--lossy-ckpt", "--ckpt-dir", str(tmp_path)])
    assert sorted(r["losses"]) == [0, 1, 2, 3]
    assert np.all(np.isfinite(list(r["losses"].values())))
    assert r["params"] == TM.count_params(TB.get_smoke(arch))
