"""The float32 route of K1 / K2 (``cuda-3xtf32``) on the CPU: its arithmetic
and its layouts against the JAX reference.

The route's kernels (``subm_conv_f32_tc_kernel`` in
``csrc/submanifold_conv.cu``; ``subm_conv_dw_pairs_count`` / ``_write``
and ``subm_conv_dw_pairs_f32_tc_kernel`` in ``csrc/submanifold_conv_dw.cu``)
run only on the card. They compute each float32 product as 3xTF32: both
operands split into a TF32 high part ``rna(x)`` and a low part
``rna(x - high)`` (round to nearest, ties away, as ``cvt.rna.tf32.f32``),
and lo*hi + hi*lo + hi*hi accumulated in float32 by ``mma.sync`` m16n8k8,
8 K rows at a time, into partial sums from zero that a float32 add joins
to the accumulator (K1: one a 32-row stage; ``d_w``: one an MMA). Held
here:

* ``sparse_conv_cuda.tf32_round`` against a float64 rounding written from
  the definition, ties and carries included;
* the weight pack (9, 2, NP, KP) that the float32 conv launch writes first
  (``sparse_conv_cuda.pack_weight_3xtf32``): high + low equal to the weight
  within one float32 unit, transposed from the ``w2d`` / ``wt2d`` blocks the
  Pallas calls receive (``test_torch_conv_tc_layout._weight_block``), zero
  past 3*Cin and Cout;
* the plain twin of ``d_w``'s pair lists (``sparse_conv_cuda.
  dw_pair_lists``): every offset's pairs exactly those the plain twin
  ``submanifold_conv_wide_dw_ref`` reads from the plan, ascending, with
  their counts; empty lists for offsets without pairs; no pair in an
  all-miss padding tile;
* a torch emulation of the kernels' sums over those packs and lists (K1,
  ``d_feats`` on the mirror pack, ``d_w`` over each offset's pair ranges
  of ``dw_ranges``' length and its fixed reduction order) against JAX's
  ``submanifold_conv_wide`` and ``jax.vjp`` to 1e-4 of the largest
  |value|, the limit chip_smoke holds the card to, at the SCN UNet's 14
  conv shapes and, through the wrappers with the launches stubbed by the
  emulation and the lists by the twin, at SPVCNN's 384 -> 256 (column
  blocks).
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


def emulate_conv_3xtf32(rows: torch.Tensor, ranks: torch.Tensor,
                        sel: torch.Tensor, pack: torch.Tensor,
                        cout: int) -> torch.Tensor:
    """What the float32 conv kernel computes from its launch arguments:
    per column c, the dz-aligned window (V, KP) of ``rows`` (slot t = k //
    Cin of K row k, zero past 3*Cin and where the slot is empty), split into
    TF32 parts, times the pack's high and low blocks, a partial sum per
    ``K_STAGE``-row stage. Returns (V, cout) float32."""
    v, cin = rows.shape
    kp = pack.shape[3]
    src = torch.from_numpy(_slot_rows_of(ranks, sel, v))
    acc = torch.zeros((v, pack.shape[2]), dtype=torch.float32)
    for c in range(9):
        a = torch.zeros((v, kp), dtype=torch.float32)
        for t in range(3):
            r = src[3 * c + t]
            ok = r >= 0
            a[ok, t * cin:(t + 1) * cin] = rows[r[ok]]
        a_hi, a_lo = _split(a)
        b_hi, b_lo = pack[c, 0].T, pack[c, 1].T
        for k0 in range(0, kp, scc.K_STAGE):
            k = slice(k0, k0 + scc.K_STAGE)
            _partial_3xtf32(acc, a_hi[:, k], a_lo[:, k], b_hi[k], b_lo[k])
    return acc[:, :cout]


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
    twin on the call's own arguments."""
    assert fn == "mopa_subm_conv_dw_pairs"
    ranks, sel, block_counts, pairs, counts, v = args
    assert block_counts.shape == (-(-v // scc.PAIR_VOXELS), 27)
    assert pairs.shape == (27, v, 2) and counts.shape == (27,)
    want_pairs, want_counts = scc.dw_pair_lists(ranks, sel, v)
    pairs.copy_(want_pairs)
    counts.copy_(want_counts)


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
def test_pack_splits_the_weight_blocks(cin, cout, mirror):
    """pack[c][0] + pack[c][1] = column c's B block transposed (the rows
    the Pallas calls' ``w2d`` / ``wt2d`` hold) within one float32 unit of
    each value, both parts TF32, zero past 3*Cin rows and Cout columns."""
    rng = np.random.default_rng(cin * 7 + cout)
    w = (rng.normal(size=(27, cin, cout)) * 0.2).astype(np.float32)
    k_in, n_out = (cout, cin) if mirror else (cin, cout)
    kp, np_ = scc.conv_tile_shape(k_in, n_out)
    assert kp % scc.K_STAGE == 0 and kp >= 3 * k_in and np_ >= n_out
    pack = scc.pack_weight_3xtf32(torch.from_numpy(w), mirror, kp, np_)
    assert pack.shape == (9, 2, np_, kp) and pack.dtype == torch.float32
    bits = pack.numpy().view(np.int32)
    assert not (bits & 0x1FFF).any()
    whole = pack[:, 0].double() + pack[:, 1].double()
    for c in range(9):
        b = _weight_block(w, c, mirror)[:3 * k_in, :n_out].T
        unit = np.exp2(np.floor(np.log2(np.maximum(np.abs(b), 1e-30))) - 23)
        assert (np.abs(whole[c, :n_out, :3 * k_in].numpy() - b)
                <= unit).all()
        assert np.array_equal(pack[c, 0, :n_out, :3 * k_in].numpy(),
                              scc.tf32_round(torch.from_numpy(
                                  b.astype(np.float32))).numpy())
    assert not pack[:, :, n_out:].any() and not pack[:, :, :, 3 * k_in:].any()


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
    """The emulated kernels on the wrapper's packs: K1, ``d_feats`` and
    ``d_w`` within 1e-4 of max|ref| of JAX's conv and its VJP."""
    lv, _ = level
    v = lv.valid.shape[0]
    rng = np.random.default_rng(cin * 1000 + cout)
    feats = rng.normal(size=(v, cin)).astype(np.float32)
    w = (rng.normal(size=(27, cin, cout)) * (2.0 / (27 * cin)) ** 0.5
         ).astype(np.float32)
    g = rng.normal(size=(v, cout)).astype(np.float32)
    want, want_df, want_dw = _jax_conv_and_vjp(lv, feats, w, g)
    ft, wt, gt = (torch.from_numpy(a) for a in (feats, w, g))
    kp, np_ = scc.conv_tile_shape(cin, cout)
    out = emulate_conv_3xtf32(ft, lv.ranks, lv.sel,
                              scc.pack_weight_3xtf32(wt, False, kp, np_),
                              cout)
    kp, np_ = scc.conv_tile_shape(cout, cin)
    d_feats = emulate_conv_3xtf32(gt, lv.ranks, lv.sel,
                                  scc.pack_weight_3xtf32(wt, True, kp, np_),
                                  cin)
    d_w = emulate_dw_3xtf32(gt, ft, *scc.dw_pair_lists(lv.ranks, lv.sel, v))
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
        rows, ranks, sel, weight, pack, out, v, cin, width, mirror, kp, \
            np_ = args
        assert (kp, np_) == scc.conv_tile_shape(cin, width)
        assert pack.shape == (9, 2, np_, kp) and weight.is_contiguous()
        pack.copy_(scc.pack_weight_3xtf32(weight, bool(mirror), kp, np_))
        out.copy_(emulate_conv_3xtf32(rows, ranks, sel, pack, width))

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
    128 output columns, ``d_feats`` 2 x 192), each block packed and
    emulated, within 1e-4 of max|ref| of JAX."""
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
    d_feats = scc.submanifold_conv_wide_bwd_dfeats_cuda(gt, lv.ranks,
                                                        lv.sel, wt)
    d_w = scc.submanifold_conv_wide_bwd_dw_cuda(gt, ft, lv.ranks, lv.sel)
    assert scc.launches[scc.K1] == scc.routes[scc.K1][scc.TF32X3] == 2
    assert scc.launches[scc.K2_DFEATS] == 2 and scc.launches[scc.K2_DW] == 2
    # one list for both column blocks of d_w
    assert scc.dw_pair_route == {"lists": 1, "launches": 2}
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
    pairs, counts = scc.dw_pair_lists(lv.ranks, lv.sel, v)
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
