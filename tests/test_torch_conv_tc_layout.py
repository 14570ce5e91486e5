"""Host-side layouts of the tensor-core conv kernels against the JAX reference.

The bfloat16 route of K1 / K2 ``d_feats`` (``csrc/submanifold_conv.cu``) and
of K2 ``d_w`` (``csrc/submanifold_conv_dw.cu``) runs only on the card. What
they rely on is held here, on the CPU, at small widths:

* the weight block each conv stage multiplies (column c's rows, zero past
  3*Cin and Cout up to the kernel's (KP, NP) tile), read in place from the
  forward weight, against the ``w2d`` that the Pallas ``_fwd_call`` receives
  and, in the mirror mode, the ``wt2d`` that ``_bwd_call`` receives;
* the kernel's column-by-column algorithm with that K padding (the stem's
  Cin = 1, Cin not a multiple of the stage depth), emulated in numpy,
  against ``jax.vjp`` of ``sparse_conv.submanifold_conv_wide``;
* the ``d_w`` kernel's per-(range, column) partial blocks (Cin, 3*Cout) and
  their scatter-back to (27, Cin, Cout), against the plain twin and
  ``jax.vjp``; the voxel ranges and the CTA tiling it is given;
* the wrappers' route choice by dtype, with the library calls stubbed.

The numpy emulations follow the index formulas written in the kernels'
sources. float64 emulation, float32 inputs: to 1e-5 of the largest |value|.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mopa_tpu.models import scn_unet as jax_unet
from mopa_tpu.ops import sparse_conv as jsc
from mopa_tpu.ops import sparse_conv_pallas as scp
from mopa_tpu_torch.models import scn_unet as port_unet
from mopa_tpu_torch.ops import sparse_conv as psc
from mopa_tpu_torch.ops import sparse_conv_cuda as scc

torch.set_num_threads(1)

S, P, LEVELS = 3, 300, 2

# (Cin, Cout): the stem; Cin not a multiple of 8 (plain-load staging) and
# 3*Cin not a multiple of the stage depth; Cin > Cout; Cout not a multiple
# of 16 (NP padding)
SHAPES = [(1, 16), (12, 20), (16, 16), (32, 16), (24, 40)]


def _close(got, want):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def level():
    """Level 0 of the port's plan of three scans (one part-padded)."""
    rng = np.random.default_rng(0)
    coords = rng.integers(0, 12, size=(S, P, 3)).astype(np.int32)
    valid = np.ones((S, P), bool)
    valid[1, int(P * 0.7):] = False
    caps = jax_unet.capacity_schedule(P, LEVELS)
    plan = port_unet.build_unet_plan_batched(
        torch.from_numpy(coords), torch.from_numpy(valid), LEVELS,
        capacities=caps)
    return plan.levels[0], caps[0]


def _inputs(seed, v, cin, cout):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(v, cin)).astype(np.float32),
            (rng.normal(size=(27, cin, cout)) * 0.2).astype(np.float32),
            rng.normal(size=(v, cout)).astype(np.float32))


def _slot_rows(lv):
    """(27, V) source row of each voxel's kernel offset 3c + t (-1: none),
    resolved as both kernels resolve it."""
    v = lv.valid.shape[0]
    ranks = lv.ranks.numpy().reshape(v, 9).astype(np.int64)
    codes = lv.sel.numpy().reshape(v, 9)
    src = np.full((27, v), -1, np.int64)
    for c in range(9):
        for j in range(3):
            t = (codes[:, c] >> (2 * j)) & 3
            row = ranks[:, c] + j
            ok = (t < 3) & (row >= 0) & (row < v)
            src[3 * c + t[ok], np.nonzero(ok)[0]] = row[ok]
    return src


def _weight_block(weight, c, mirror):
    """Column c's (KP, NP) B block as the conv kernel stages it from the
    FORWARD weight (27, Cin_f, Cout_f). Forward: B[k][n] = row 3c*cin + k
    of the (27*cin, cout) weight. Mirror (cin = Cout_f, cout = Cin_f):
    B[k][n] = weight[26 - 3c - t][n][k % cin], t = k // cin. Zero past
    3*cin rows and cout columns."""
    cin, cout = (weight.shape[2], weight.shape[1]) if mirror \
        else (weight.shape[1], weight.shape[2])
    kp, np_ = scc.conv_tile_shape(cin, cout)
    b = np.zeros((kp, np_), np.float64)
    flat = weight.reshape(-1)
    for k in range(3 * cin):
        t, ci = divmod(k, cin)
        for n in range(cout):
            b[k, n] = weight[26 - 3 * c - t, n, ci] if mirror \
                else flat[(3 * c * cin + k) * cout + n]
    return b


def _emulate_conv(feats, src, weight, mirror):
    """The tensor-core conv kernel's sum in float64: per column, the
    dz-aligned window (slot t = k // cin of K row k, zero past 3*cin) times
    the staged weight block."""
    v, cin = feats.shape
    cout = weight.shape[1] if mirror else weight.shape[2]
    kp, np_ = scc.conv_tile_shape(cin, cout)
    out = np.zeros((v, np_))
    for c in range(9):
        a = np.zeros((v, kp))
        for k in range(3 * cin):
            t, ci = divmod(k, cin)
            rows = src[3 * c + t]
            a[rows >= 0, k] = feats[rows[rows >= 0], ci]
        out += a @ _weight_block(weight, c, mirror)
    return out[:, :cout]


@contextlib.contextmanager
def _captured_pallas_weights(store):
    """Record the weight operand each Pallas call receives."""
    fwd, bwd, interp = scp._fwd_call, scp._bwd_call, scp._INTERPRET

    def fwd_spy(*args, **kw):
        store["w2d"] = np.asarray(args[3])
        return fwd(*args, **kw)

    def bwd_spy(*args, **kw):
        store["wt2d"] = np.asarray(args[3])
        return bwd(*args, **kw)

    scp._fwd_call, scp._bwd_call, scp._INTERPRET = fwd_spy, bwd_spy, True
    try:
        yield
    finally:
        scp._fwd_call, scp._bwd_call, scp._INTERPRET = fwd, bwd, interp


@pytest.mark.parametrize("cin,cout", SHAPES)
def test_weight_blocks_match_pallas_w2d_and_wt2d(level, cin, cout):
    """Forward blocks = the rows of ``w2d`` column c multiplies; mirror
    blocks = the rows of the mirrored, transposed ``wt2d``; zero padding."""
    lv, cap = level
    v = lv.valid.shape[0]
    feats, w, g = _inputs(cin * 100 + cout, v, cin, cout)
    lr, ls = scp.localize_plan(jnp.asarray(lv.ranks.numpy()),
                               jnp.asarray(lv.sel.numpy()), cap, S)
    store = {}
    with _captured_pallas_weights(store):
        out, vjp = jax.vjp(
            lambda f, w_: scp.submanifold_conv_wide_pallas(f, lr, ls, w_,
                                                           cap, S),
            jnp.asarray(feats), jnp.asarray(w))
        vjp(jnp.asarray(g))
    assert store["w2d"].shape == (27 * cin, cout)
    assert store["wt2d"].shape == (27 * cout, cin)
    for mirror, ref, k_in in ((False, store["w2d"], cin),
                              (True, store["wt2d"], cout)):
        n_out = cout if not mirror else cin
        for c in range(9):
            b = _weight_block(w, c, mirror)
            np.testing.assert_array_equal(
                b[:3 * k_in, :n_out], ref[3 * k_in * c:3 * k_in * (c + 1)])
            assert not b[3 * k_in:].any() and not b[:, n_out:].any()


@pytest.mark.parametrize("cin,cout", SHAPES)
def test_emulated_kernel_matches_jax_vjp(level, cin, cout):
    """The column-by-column sum over padded K gives the forward and, in the
    mirror mode on the cotangent, ``d_feats`` of ``jax.vjp``."""
    lv, _ = level
    v = lv.valid.shape[0]
    feats, w, g = _inputs(cin * 10 + cout, v, cin, cout)
    kp, np_ = scc.conv_tile_shape(cin, cout)
    assert kp % scc.K_STAGE == 0 and kp >= 3 * cin
    assert np_ >= cout and np_ // 16 in scc.NT_CHOICES
    wide = jsc.WidePlan(jnp.asarray(lv.ranks.numpy()),
                        jnp.asarray(lv.sel.numpy()))
    out, vjp = jax.vjp(lambda f, w_: jsc.submanifold_conv_wide(f, wide, w_),
                       jnp.asarray(feats), jnp.asarray(w))
    d_feats, _ = vjp(jnp.asarray(g))
    src = _slot_rows(lv)
    _close(_emulate_conv(feats, src, w, mirror=False), out)
    _close(_emulate_conv(g, src, w, mirror=True), d_feats)


@pytest.mark.parametrize("cin,cout", SHAPES)
def test_dw_column_blocks_scatter_back(level, cin, cout):
    """Per (range, column) partial blocks P[r][c] (Cin, 3*Cout) =
    feats[range]^T @ aligned g, added over the ranges in order and written
    as d_w[26 - (3c + t)][ci][co] = P[c][ci][t*Cout + co]: the plain twin
    and ``jax.vjp``'s d_w."""
    lv, _ = level
    v = lv.valid.shape[0]
    feats, w, g = _inputs(cin + cout, v, cin, cout)
    src = _slot_rows(lv)
    ranges, rows = scc.dw_ranges(v)
    part = np.zeros((ranges, 9, cin, 3 * cout))
    for r in range(ranges):
        vs = np.arange(r * rows, min(v, (r + 1) * rows))
        for c in range(9):
            win = np.zeros((len(vs), 3 * cout))
            for t in range(3):
                rr = src[3 * c + t, vs]
                win[rr >= 0, t * cout:(t + 1) * cout] = g[rr[rr >= 0]]
            part[r, c] = feats[vs].astype(np.float64).T @ win
    total = part.sum(axis=0)
    dw = np.zeros((27, cin, cout))
    for k in range(27):
        c, t = divmod(26 - k, 3)
        dw[k] = total[c][:, t * cout:(t + 1) * cout]

    _close(dw, psc.submanifold_conv_wide_dw_ref(
        torch.from_numpy(g), torch.from_numpy(feats), lv.ranks,
        lv.sel).numpy())
    wide = jsc.WidePlan(jnp.asarray(lv.ranks.numpy()),
                        jnp.asarray(lv.sel.numpy()))
    _, vjp = jax.vjp(lambda f, w_: jsc.submanifold_conv_wide(f, wide, w_),
                     jnp.asarray(feats), jnp.asarray(w))
    _close(dw, vjp(jnp.asarray(g))[1])


@pytest.mark.parametrize("v", [0, 1, 31, 2048, 4448, 12320, 249024, 300000])
def test_dw_ranges_cover_every_row_once(v):
    ranges, rows = scc.dw_ranges(v)
    assert 1 <= ranges <= scc.MAX_RANGES and rows % scc.K_STAGE == 0
    seen = np.zeros(v, np.int64)
    for r in range(ranges):
        seen[r * rows:min(v, (r + 1) * rows)] += 1
    assert (seen == 1).all()
    assert v == 0 or ranges * rows - v < rows  # no wholly empty range
    assert scc.dw_ranges(v) == (ranges, rows)


@pytest.mark.parametrize("cin,cout", SHAPES + [(96, 48), (112, 112),
                                               (192, 96), (96, 192),
                                               (16, 192)])
def test_dw_tiling_covers_the_block(cin, cout):
    wm, nt = scc.dw_tiling(cin, cout)
    assert wm in (1, 2, 4) and nt in scc.NT_CHOICES
    assert 16 * nt * (8 // wm) >= 3 * cout
    assert 16 * wm <= max(16, cin) * 2  # no CTA row block past 2*Cin


class _FakeLib:
    """Library functions that record their arguments and succeed."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return 0
        return fn


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, scc.TENSOR_CORE),
                                         (torch.float32, scc.TF32X3)])
def test_wrappers_choose_the_route_by_dtype(level, monkeypatch, dtype,
                                            route):
    """bfloat16 calls the tensor-core entry points, float32 the 3xTF32 ones
    (K1 over pair lists and a span table built first, with a (27, 2, NP,
    KPC) scratch for the weight's split pack; the backward's ``d_feats``
    and ``d_w`` over one set built for both), with the tile
    shape, the mirror flag and the d_w tiling; each launch counts once
    under its kernel and route, and on the float32 route in ``pair_route``
    by kernel, the pair lists not as a launch."""
    lv, _ = level
    v = lv.valid.shape[0]
    cin, cout = 24, 40
    libs = {"conv": _FakeLib(), "dw": _FakeLib()}
    monkeypatch.setattr(scc, "_require_cuda", lambda x, what: None)
    monkeypatch.setattr(scc, "build", lambda: libs)
    monkeypatch.setattr(scc, "_stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    feats = torch.zeros(v, cin, dtype=dtype)
    g = torch.zeros(v, cout, dtype=dtype)
    w = torch.zeros(27, cin, cout, dtype=dtype)
    scc.reset_launch_counts()
    out = scc.submanifold_conv_wide_cuda(feats, lv.ranks, lv.sel, w)
    d_feats, d_w = scc.submanifold_conv_wide_bwd_cuda(g, feats, lv.ranks,
                                                      lv.sel, w)
    assert out.shape == (v, cout) and out.dtype == dtype
    assert d_feats.shape == (v, cin) and d_feats.dtype == dtype
    assert d_w.shape == (27, cin, cout) and d_w.dtype == torch.float32
    (fwd_name, fwd), (bwd_name, bwd) = libs["conv"].calls
    ranges, rows = scc.dw_ranges(v)
    if route == scc.TENSOR_CORE:
        (dw_name, dw), = libs["dw"].calls
        assert (fwd_name, bwd_name, dw_name) == (
            "mopa_subm_conv_tc", "mopa_subm_conv_tc", "mopa_subm_conv_dw_tc")
        assert dw[2:4] == (lv.ranks.data_ptr(), lv.sel.data_ptr())
        assert dw[6:] == (v, cin, cout, ranges, rows,
                          *scc.dw_tiling(cin, cout), 0)
        for call in (fwd, bwd):
            assert call[1:3] == (lv.ranks.data_ptr(), lv.sel.data_ptr())
        assert fwd[5:] == (v, cin, cout, 0, *scc.conv_tile_shape(cin, cout),
                           0)
        assert bwd[5:] == (v, cout, cin, 1, *scc.conv_tile_shape(cout, cin),
                           0)
    else:
        (fl_name, f_lists), (bl_name, b_lists), (dw_name, dw) = \
            libs["dw"].calls
        assert (fwd_name, bwd_name, fl_name, bl_name, dw_name) == (
            "mopa_subm_conv_f32", "mopa_subm_conv_f32",
            "mopa_subm_conv_pairs", "mopa_subm_conv_pairs",
            "mopa_subm_conv_dw_f32")
        # the plan in; (block counts, pairs, counts, span starts) out
        for lists in (f_lists, b_lists):
            assert lists[:2] == (lv.ranks.data_ptr(), lv.sel.data_ptr())
            assert lists[6:] == (v, scc.PAIR_SPAN, 0)
        # K1 on the forward's pairs and starts, d_feats and d_w on the
        # backward's; the pack's scratch between the weight and the output
        fwd, bwd = fwd[:4] + fwd[5:], bwd[:4] + bwd[5:]
        assert fwd[1:3] == (f_lists[3], f_lists[5])
        assert bwd[1:3] == (b_lists[3], b_lists[5])
        assert dw[2:4] == b_lists[3:5]
        assert fwd[5:] == (v, cin, cout, 0, scc.conv_tile_shape(cin, cout)[1],
                           scc.PAIR_SPAN, 0)
        assert bwd[5:] == (v, cout, cin, 1, scc.conv_tile_shape(cout, cin)[1],
                           scc.PAIR_SPAN, 0)
        assert dw[6:] == (v, cin, cout, ranges, rows,
                          *scc.dw_pair_tiling(cin, cout), 0)
    # the forward weight is passed in place in both modes
    assert fwd[3] == bwd[3] == w.data_ptr()
    other = scc.TF32X3 if route == scc.TENSOR_CORE else scc.TENSOR_CORE
    for name in (scc.K1, scc.K2_DFEATS, scc.K2_DW):
        assert scc.launches[name] == 1
        assert scc.routes[name] == {route: 1, other: 0}
    n = int(route == scc.TF32X3)
    assert scc.pair_route == {"lists": 2 * n, "k1": n, "dfeats": n, "dw": n}
    scc.reset_launch_counts()
    assert not any(scc.launches.values())
    assert not any(n for r in scc.routes.values() for n in r.values())
    assert not any(scc.pair_route.values())
