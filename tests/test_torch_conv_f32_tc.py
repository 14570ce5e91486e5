"""The float32 route of K1 / K2 (``cuda-3xtf32``) on the CPU: its arithmetic
and its layouts against the JAX reference.

The route's kernels (``subm_conv_pairs_f32_tc_kernel`` in
``csrc/submanifold_conv.cu``; ``subm_conv_dw_pairs_count`` / ``_write``
and ``subm_conv_dw_pairs_f32_tc_kernel`` in ``csrc/submanifold_conv_dw.cu``)
run only on the card. All three work over the neighbour pairs that exist,
listed per kernel offset. They compute each float32 product as 3xTF32:
both operands split into a TF32 high part ``rna(x)`` and a low part
``rna(x - high)`` (round to nearest, ties away, as ``cvt.rna.tf32.f32``),
and lo*hi + hi*lo + hi*hi accumulated in float32 by ``mma.sync`` m16n8k8,
8 K rows at a time, each MMA's products summed from zero and joined to the
accumulator by a float32 add. Held here:

* ``sparse_conv_cuda.tf32_round`` against a float64 rounding written from
  the definition, ties and carries included;
* the weight pack (27, 2, NP, KPC) that the float32 conv launch writes
  first (``sparse_conv_cuda.pair_pack_3xtf32``): per list, high + low
  equal to the weight within one float32 unit, transposed from the rows
  of the window blocks (``test_torch_conv_tc_layout._weight_block``, held
  there to the ``w2d`` / ``wt2d`` the Pallas calls receive), zero past
  Cin and Cout;
* the plain twin of the pair lists (``sparse_conv_cuda.pair_lists``):
  every offset's pairs exactly those the plain twin
  ``submanifold_conv_wide_dw_ref`` reads from the plan, ascending, with
  their counts; empty lists for offsets without pairs; no pair in an
  all-miss padding tile; and of the span table
  (``sparse_conv_cuda.span_starts``) against a loop over the lists;
* a torch emulation of the kernels' sums from their launch arguments (K1
  and ``d_feats`` over each span's pairs of each offset, in offset order;
  ``d_w`` over each offset's pair ranges of ``dw_ranges``' length and its
  fixed reduction order) against JAX's ``submanifold_conv_wide`` and
  ``jax.vjp`` to 1e-4 of the largest |value|, the limit chip_smoke holds
  the card to, at the SCN UNet's 14 conv shapes and, through the wrappers
  with the launches stubbed by the emulation and the lists by the twin,
  at SPVCNN's 384 -> 256 (column blocks).
"""

import contextlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mopa_tpu.models import scn_unet as jax_unet
from mopa_tpu.ops import sparse_conv as jsc
from mopa_tpu_torch.models import scn_unet as port_unet
from mopa_tpu_torch.ops import sparse_conv as psc
from mopa_tpu_torch.ops import sparse_conv_cuda as scc

from test_torch_conv_tc_layout import _slot_rows, _weight_block
from test_torch_conv_tc_layout import level  # noqa: F401 (fixture)

torch.set_num_threads(1)

M, NUM_PLANES = 16, 7  # the SCN UNet of the shipped configs
MMA_K = 8              # K rows of one mma.sync m16n8k8


def scn_conv_shapes():
    """(Cin, Cout) of the SCN UNet's 14 submanifold convs."""
    planes = [(i + 1) * M for i in range(NUM_PLANES)]
    return [(1, M)] + [(p, p) for p in planes] \
        + [(2 * p, p) for p in planes[:-1]]


def _split(x: torch.Tensor) -> tuple:
    hi = scc.tf32_round(x)
    return hi, scc.tf32_round(x - hi)


def _partial_3xtf32(acc, a_hi, a_lo, b_hi, b_lo) -> None:
    """acc += A @ B over (M, K) and (K, N) split operands, as a kernel adds
    one partial sum: from zero, MMA_K rows at a time, small terms first,
    each product in float32; then added to ``acc``."""
    part = torch.zeros_like(acc)
    for k0 in range(0, a_hi.shape[1], MMA_K):
        k = slice(k0, k0 + MMA_K)
        part += a_lo[:, k] @ b_hi[k]
        part += a_hi[:, k] @ b_lo[k]
        part += a_hi[:, k] @ b_hi[k]
    acc += part


def emulate_conv_3xtf32(rows: torch.Tensor, pairs: torch.Tensor,
                        starts: torch.Tensor, pack: torch.Tensor,
                        width: int) -> torch.Tensor:
    """What the float32 conv kernel computes from its launch arguments: per
    span s of ``PAIR_SPAN`` output voxels and list k (its entries
    ``[starts[s][k], starts[s + 1][k])``), in the order of k, the gathered
    rows of the pairs, split into TF32 parts, times the pack's high and low
    blocks of list k, in 8-row MMA steps, each step's products from zero
    added to the offset's sums, which are then added into the pairs' output
    rows. Returns (V, width) float32."""
    v, cin = rows.shape
    span = scc.PAIR_SPAN
    assert starts.shape == (-(-v // span) + 1, 27)
    r_hi, r_lo = _split(rows)
    out = torch.zeros((v, width), dtype=torch.float32)
    for k in range(27):
        b_hi, b_lo = pack[k, 0, :width, :cin].T, pack[k, 1, :width, :cin].T
        idx = []
        for s in range(len(starts) - 1):
            a, e = int(starts[s, k]), int(starts[s + 1, k])
            vox = pairs[k, a:e, 0].long()
            assert ((vox >= s * span) & (vox < (s + 1) * span)).all()
            idx.append(torch.arange(a, e))
        pr = pairs[k, torch.cat(idx)].long()
        acc = torch.zeros((len(pr), width), dtype=torch.float32)
        for k0 in range(0, cin, MMA_K):
            kk = slice(k0, k0 + MMA_K)
            _partial_3xtf32(acc, r_hi[pr[:, 1]][:, kk], r_lo[pr[:, 1]][:, kk],
                            b_hi[kk], b_lo[kk])
        out[pr[:, 0]] += acc  # one pair a voxel in a list
    return out


def emulate_dw_3xtf32(g: torch.Tensor, feats: torch.Tensor,
                      pairs: torch.Tensor, counts: torch.Tensor
                      ) -> torch.Tensor:
    """What the float32 ``d_w`` kernel and its reduction compute from their
    launch's pair lists: per offset k and range of ``dw_ranges``' length
    over k's pairs, the pairs' feats rows^T (Cin, pairs) times their
    cotangent rows (pairs, Cout), both split into TF32 parts, a partial sum
    per MMA_K pairs from zero (zero rows past the range); the ranges that
    hold pairs added in order; no pair, zeros. Returns (27, Cin, Cout)
    float32."""
    v, cout = g.shape
    cin = feats.shape[1]
    _, rows = scc.dw_ranges(v)
    dw = torch.zeros((27, cin, cout), dtype=torch.float32)
    for k in range(27):
        n = int(counts[k])
        total = None
        for p0 in range(0, n, rows):
            pr = pairs[k, p0:min(n, p0 + rows)].long()
            m = -(-len(pr) // MMA_K) * MMA_K
            f = torch.zeros((m, cin), dtype=torch.float32)
            f[:len(pr)] = feats[pr[:, 0]]
            w = torch.zeros((m, cout), dtype=torch.float32)
            w[:len(pr)] = g[pr[:, 1]]
            f_hi, f_lo = _split(f)
            w_hi, w_lo = _split(w)
            part = torch.zeros((cin, cout), dtype=torch.float32)
            for k0 in range(0, m, MMA_K):
                kk = slice(k0, k0 + MMA_K)
                _partial_3xtf32(part, f_hi[kk].T, f_lo[kk].T, w_hi[kk],
                                w_lo[kk])
            total = part if total is None else total + part
        if total is not None:
            dw[k] = total
    return dw


def twin_pair_lists(what, fn, device, *args) -> None:
    """The pair-list library call (``sparse_conv_cuda._call``) done by the
    twins on the call's own arguments."""
    assert fn == "mopa_subm_conv_pairs"
    ranks, sel, block_counts, pairs, counts, starts, v, span = args
    assert block_counts.shape == (-(-v // scc.PAIR_VOXELS), 27)
    assert pairs.shape == (27, v, 2) and counts.shape == (27,)
    want_pairs, want_counts = scc.pair_lists(ranks, sel, v)
    pairs.copy_(want_pairs)
    counts.copy_(want_counts)
    if span:
        starts.copy_(scc.span_starts(want_pairs, want_counts, v, span))
    else:
        assert starts is None


def _slot_rows_of(ranks, sel, v):
    return _slot_rows(SimpleNamespace(ranks=ranks, sel=sel,
                                      valid=torch.empty(v)))


def _rna_reference(x: np.ndarray) -> np.ndarray:
    """TF32 rounding from its definition, in float64: |x| to the nearest
    multiple of its TF32 unit 2^(floor(log2 |x|) - 10), ties away from
    zero (normal, nonzero x)."""
    x = x.astype(np.float64)
    unit = np.exp2(np.floor(np.log2(np.abs(x))) - 10)
    return np.sign(x) * np.floor(np.abs(x) / unit + 0.5) * unit


def test_tf32_round_is_round_to_nearest_away():
    one = 1.0
    ties = np.array([one + 2.0 ** -11, -(one + 2.0 ** -11),
                     one + 3 * 2.0 ** -11, 2.0 - 2.0 ** -12,
                     -(2.0 - 2.0 ** -12), one + 2.0 ** -11 - 2.0 ** -23,
                     3.0 * 2.0 ** -100, 1.5 * 2.0 ** 100],
                    np.float32)
    want = np.array([one + 2.0 ** -10, -(one + 2.0 ** -10),
                     one + 2 * 2.0 ** -10, 2.0, -2.0, one,
                     3.0 * 2.0 ** -100, 1.5 * 2.0 ** 100])
    got = scc.tf32_round(torch.from_numpy(ties)).numpy()
    np.testing.assert_array_equal(got.astype(np.float64), want)
    rng = np.random.default_rng(0)
    x = (rng.normal(size=20000) * np.exp2(rng.integers(-30, 30, 20000))
         ).astype(np.float32)
    x = x[x != 0]
    got = scc.tf32_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.astype(np.float64), _rna_reference(x))
    assert not (got.view(np.int32) & 0x1FFF).any()
    hi = torch.from_numpy(got)
    lo = scc.tf32_round(torch.from_numpy(x) - hi).numpy()
    assert not (lo.view(np.int32) & 0x1FFF).any()


@pytest.mark.parametrize("cin,cout", [(1, 16), (12, 20), (16, 16),
                                      (32, 16), (24, 40), (192, 96)])
@pytest.mark.parametrize("mirror", [False, True], ids=["k1", "d_feats"])
def test_pair_pack_splits_the_window_rows(cin, cout, mirror):
    """pack[k][0] + pack[k][1], k = 26 - (3c + t), is slot t's rows of
    column c's window block (the rows the Pallas calls' ``w2d`` / ``wt2d``
    hold) transposed, within one float32 unit of each value; both parts
    TF32, the high part the rounded weight; zero past Cin rows (to a
    multiple of the stage depth) and the width's columns (to NP)."""
    rng = np.random.default_rng(cin * 7 + cout)
    w = (rng.normal(size=(27, cin, cout)) * 0.2).astype(np.float32)
    k_in, n_out = (cout, cin) if mirror else (cin, cout)
    np_ = scc.conv_tile_shape(k_in, n_out)[1]
    assert np_ >= n_out and np_ // 16 in scc.NT_CHOICES
    pack = scc.pair_pack_3xtf32(torch.from_numpy(w), mirror, np_)
    kpc = -(-k_in // scc.K_STAGE) * scc.K_STAGE
    assert pack.shape == (27, 2, np_, kpc) and pack.dtype == torch.float32
    assert not (pack.numpy().view(np.int32) & 0x1FFF).any()
    whole = pack[:, 0].double() + pack[:, 1].double()
    for c in range(9):
        win = _weight_block(w, c, mirror)
        for t in range(3):
            k = 26 - (3 * c + t)
            b = win[t * k_in:(t + 1) * k_in, :n_out].T
            unit = np.exp2(np.floor(np.log2(np.maximum(np.abs(b), 1e-30)))
                           - 23)
            assert (np.abs(whole[k, :n_out, :k_in].numpy() - b)
                    <= unit).all()
            assert np.array_equal(pack[k, 0, :n_out, :k_in].numpy(),
                                  scc.tf32_round(torch.from_numpy(
                                      b.astype(np.float32))).numpy())
    assert not pack[:, :, n_out:].any() and not pack[:, :, :, k_in:].any()


def _close(got, want, rel=1e-4):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=rel * np.abs(want).max())


def _jax_conv_and_vjp(lv, feats, w, g):
    wide = jsc.WidePlan(jnp.asarray(lv.ranks.numpy()),
                        jnp.asarray(lv.sel.numpy()))
    out, vjp = jax.vjp(lambda f, w_: jsc.submanifold_conv_wide(f, wide, w_),
                       jnp.asarray(feats), jnp.asarray(w))
    return (out, *vjp(jnp.asarray(g)))


@pytest.mark.parametrize("cin,cout", scn_conv_shapes())
def test_emulated_3xtf32_matches_jax_vjp(level, cin, cout):
    """The emulated kernels over the twin's lists and span table: K1,
    ``d_feats`` and ``d_w`` within 1e-4 of max|ref| of JAX's conv and its
    VJP."""
    lv, _ = level
    v = lv.valid.shape[0]
    rng = np.random.default_rng(cin * 1000 + cout)
    feats = rng.normal(size=(v, cin)).astype(np.float32)
    w = (rng.normal(size=(27, cin, cout)) * (2.0 / (27 * cin)) ** 0.5
         ).astype(np.float32)
    g = rng.normal(size=(v, cout)).astype(np.float32)
    want, want_df, want_dw = _jax_conv_and_vjp(lv, feats, w, g)
    ft, wt, gt = (torch.from_numpy(a) for a in (feats, w, g))
    pairs, counts = scc.pair_lists(lv.ranks, lv.sel, v)
    starts = scc.span_starts(pairs, counts, v)
    out = emulate_conv_3xtf32(
        ft, pairs, starts,
        scc.pair_pack_3xtf32(wt, False, scc.conv_tile_shape(cin, cout)[1]),
        cout)
    d_feats = emulate_conv_3xtf32(
        gt, pairs, starts,
        scc.pair_pack_3xtf32(wt, True, scc.conv_tile_shape(cout, cin)[1]),
        cin)
    d_w = emulate_dw_3xtf32(gt, ft, pairs, counts)
    _close(out, want)
    _close(d_feats, want_df)
    _close(d_w, want_dw)


@pytest.fixture
def emulated_launches(monkeypatch):
    """Route every library launch to the emulation of its float32 kernel on
    the launch's own arguments, counting it as ``_launch`` does, and the
    pair lists to their twin."""

    def launch(kernel, route, fn, device, *args):
        assert route == scc.TF32X3
        scc.launches[kernel] += 1
        scc.routes[kernel][route] += 1
        if kernel == scc.K2_DW:
            feats, g, pairs, counts, partial, out = args[:6]
            v, cin, cout, ranges, rows, wm, wn = args[6:]
            assert (ranges, rows) == scc.dw_ranges(v)
            assert (wm, wn) == scc.dw_pair_tiling(cin, cout)
            assert 1 <= wm <= 4 and 1 <= wn <= 4  # at most 512 threads
            assert partial.shape == (ranges, 27, cin, cout)
            assert pairs.shape == (27, v, 2) and counts.shape == (27,)
            out.copy_(emulate_dw_3xtf32(g, feats, pairs, counts))
            return
        rows, pairs, starts, weight, pack, out, v, cin, width, mirror, \
            np_, span = args
        assert np_ == scc.conv_tile_shape(cin, width)[1]
        assert span == scc.PAIR_SPAN and weight.is_contiguous()
        assert pairs.shape == (27, v, 2)
        pack.copy_(scc.pair_pack_3xtf32(weight, bool(mirror), np_))
        out.copy_(emulate_conv_3xtf32(rows, pairs, starts, pack, width))

    monkeypatch.setattr(scc, "_require_cuda", lambda x, what: None)
    lib = type("Lib", (), {"__getattr__": lambda self, name: name})()
    monkeypatch.setattr(scc, "build", lambda: {"conv": lib, "dw": lib})
    monkeypatch.setattr(scc, "_launch", launch)
    monkeypatch.setattr(scc, "_call", twin_pair_lists)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    scc.reset_launch_counts()
    yield
    scc.reset_launch_counts()


def test_spvcnn_wide_shape_through_the_wrappers(level, emulated_launches):
    """SPVCNN's 384 -> 256: the wrappers' column blocks (K1 and ``d_w`` 2 x
    128 output columns, ``d_feats`` 2 x 192), each block emulated, within
    1e-4 of max|ref| of JAX; one set of pair lists for K1's blocks and one
    for the backward's ``d_feats`` and ``d_w`` together."""
    lv, _ = level
    v = lv.valid.shape[0]
    cin, cout = 384, 256
    rng = np.random.default_rng(384256)
    feats = rng.normal(size=(v, cin)).astype(np.float32)
    w = (rng.normal(size=(27, cin, cout)) * (2.0 / (27 * cin)) ** 0.5
         ).astype(np.float32)
    g = rng.normal(size=(v, cout)).astype(np.float32)
    ft, wt, gt = (torch.from_numpy(a) for a in (feats, w, g))
    out = scc.submanifold_conv_wide_cuda(ft, lv.ranks, lv.sel, wt)
    d_feats, d_w = scc.submanifold_conv_wide_bwd_cuda(gt, ft, lv.ranks,
                                                      lv.sel, wt)
    assert scc.launches[scc.K1] == scc.routes[scc.K1][scc.TF32X3] == 2
    assert scc.launches[scc.K2_DFEATS] == 2 and scc.launches[scc.K2_DW] == 2
    assert scc.pair_route == {"lists": 2, "k1": 2, "dfeats": 2, "dw": 2}
    want, want_df, want_dw = _jax_conv_and_vjp(lv, feats, w, g)
    _close(out, want)
    _close(d_feats, want_df)
    _close(d_w, want_dw)


def _offset_rows(lv) -> np.ndarray:
    """(27, V): the cotangent row the plain twin ``d_w`` pairs with input
    row v at offset k, -1 where none, read off
    ``submanifold_conv_wide_dw_ref`` itself: feats one-hot by voxel, the
    cotangent each row's index + 1, so d_w[k][v] is 1 + the row (0: none)."""
    v = lv.valid.shape[0]
    g = torch.arange(1, v + 1, dtype=torch.float64)[:, None]
    dw = psc.submanifold_conv_wide_dw_ref(g, torch.eye(v, dtype=torch.float64),
                                          lv.ranks, lv.sel)
    return dw[:, :, 0].round().long().numpy() - 1


def _check_lists(lv) -> tuple:
    v = lv.valid.shape[0]
    pairs, counts = scc.pair_lists(lv.ranks, lv.sel, v)
    assert pairs.shape == (27, v, 2) and pairs.dtype == torch.int32
    assert counts.shape == (27,) and counts.dtype == torch.int32
    want = _offset_rows(lv)
    for k in range(27):
        rows = np.nonzero(want[k] >= 0)[0]
        assert int(counts[k]) == len(rows)
        got = pairs[k, :len(rows)].numpy()
        np.testing.assert_array_equal(got[:, 0], rows)  # ascending
        np.testing.assert_array_equal(got[:, 1], want[k, rows])
        assert (pairs[k, len(rows):] == -1).all()
    return pairs, counts


def test_pair_lists_match_the_plain_twin(level):
    """Every offset's list holds exactly the (input row, cotangent row)
    pairs the plain twin's ``d_w`` sums, ascending by input row, with its
    count; the centre offset pairs each real voxel with itself."""
    lv, _ = level
    pairs, counts = _check_lists(lv)
    n_real = int(lv.valid.sum())
    assert int(counts[13]) == n_real
    np.testing.assert_array_equal(pairs[13, :n_real, 0].numpy(),
                                  pairs[13, :n_real, 1].numpy())
    assert int(counts.sum()) < 27 * n_real


def _plan_level(coords: np.ndarray, valid: np.ndarray):
    return port_unet.build_unet_plan_batched(
        torch.from_numpy(coords), torch.from_numpy(valid), 1,
        capacities=jax_unet.capacity_schedule(coords.shape[1], 1)).levels[0]


def test_pair_lists_empty_offsets(emulated_launches):
    """Scans flat in z: the offsets with dz != 0 list no pair (count 0,
    nothing written), the others as the twin; ``d_w`` through the wrapper
    is zero there and matches JAX's VJP."""
    rng = np.random.default_rng(3)
    coords = rng.integers(0, 12, size=(2, 200, 3)).astype(np.int32)
    coords[..., 2] = 5
    lv = _plan_level(coords, np.ones((2, 200), bool))
    pairs, counts = _check_lists(lv)
    dz0 = [k for k in range(27) if k % 3 == 1]  # offset k = 9 dx + 3 dy + dz
    assert all(int(counts[k]) == 0 for k in range(27) if k not in dz0)
    assert all(int(counts[k]) > 0 for k in dz0)
    v = lv.valid.shape[0]
    g = rng.normal(size=(v, 24)).astype(np.float32)
    feats = rng.normal(size=(v, 16)).astype(np.float32)
    d_w = scc.submanifold_conv_wide_bwd_dw_cuda(
        torch.from_numpy(g), torch.from_numpy(feats), lv.ranks, lv.sel)
    assert not d_w[[k for k in range(27) if k not in dz0]].any()
    w = np.zeros((27, 16, 24), np.float32)
    _close(d_w, _jax_conv_and_vjp(lv, feats, w, g)[2])


def test_pair_lists_skip_padding_tiles():
    """A plan whose second scan is mostly padding: the tiles of all-miss
    codes (padding) hold no listed pair, as input or cotangent row."""
    rng = np.random.default_rng(1)
    coords = rng.integers(0, 12, size=(3, 300, 3)).astype(np.int32)
    valid = np.ones((3, 300), bool)
    valid[1, 30:] = False
    lv = _plan_level(coords, valid)
    pairs, counts = _check_lists(lv)
    v = lv.valid.shape[0]
    miss = (lv.sel.reshape(v, 9) == 0b111111).all(dim=1)
    n = v // scc.TILE_M * scc.TILE_M
    tiles = miss[:n].reshape(-1, scc.TILE_M).all(dim=1)
    assert tiles.any()
    in_tile = torch.zeros(v, dtype=torch.bool)
    in_tile[:n] = tiles.repeat_interleave(scc.TILE_M)
    for k in range(27):
        listed = pairs[k, :int(counts[k])].long()
        assert not in_tile[listed[:, 0]].any()
        assert not in_tile[listed[:, 1]].any()


def _span_table_loop(pairs, counts, v, span):
    """The span table by a loop over the lists' entries."""
    n = -(-v // span)
    want = np.zeros((n + 1, 27), np.int64)
    for k in range(27):
        for s in range(n + 1):
            want[s, k] = sum(1 for p in range(int(counts[k]))
                             if int(pairs[k, p, 0]) < s * span)
    return want


@pytest.mark.parametrize("plan", ["padding_tiles", "flat_in_z"])
def test_span_table_matches_a_loop_over_the_lists(plan):
    """The span table equals a loop over the lists, on a plan whose second
    scan is mostly padding (whole spans without a pair: their rows equal)
    and on one flat in z (the 18 dz != 0 offsets' columns all zero); span
    s's entries of list k are its pairs, the last row the counts."""
    rng = np.random.default_rng(5)
    coords = rng.integers(0, 12, size=(3, 300, 3)).astype(np.int32)
    valid = np.ones((3, 300), bool)
    if plan == "padding_tiles":
        valid[1, 30:] = False
    else:
        coords[..., 2] = 5
    lv = _plan_level(coords, valid)
    v = lv.valid.shape[0]
    pairs, counts = scc.pair_lists(lv.ranks, lv.sel, v)
    for span in (scc.PAIR_SPAN, 32):
        starts = scc.span_starts(pairs, counts, v, span)
        assert starts.shape == (-(-v // span) + 1, 27)
        assert starts.dtype == torch.int32
        np.testing.assert_array_equal(starts.numpy(),
                                      _span_table_loop(pairs, counts, v,
                                                       span))
        np.testing.assert_array_equal(starts[-1].numpy(), counts.numpy())
    starts = scc.span_starts(pairs, counts, v).numpy()
    empty = (starts[1:] == starts[:-1]).all(axis=1)
    if plan == "padding_tiles":
        assert empty.any()
    else:
        dz = [k for k in range(27) if k % 3 != 1]
        assert not starts[:, dz].any() and starts[-1, 13] > 0
