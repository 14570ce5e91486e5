"""The port's gather probes (P1 ``row_gather``, P2 ``gather_gemm`` and the
probe script) against ``tools/gather_micro.py``.

Inputs are the probe's own (``make_inputs``: seeded numpy draws in the
reference's order, ranks sorted per sample) at S=2, V=256, C=16, Cout=16.

* P1's twin equals the reference ``xla`` probe's gather expression and P1's
  Pallas body run in interpret mode, bit for bit. The body is the
  reference's with ``[0]`` indexing, as its ``fused`` sibling indexes: as
  written it reads the whole (1, V, 3C) block and fails (ROADMAP Queue 3).
* P2's twin equals P2's Pallas body, exactly as written, in interpret mode to
  one bfloat16 ulp: max|err| <= 2**-7 * max|ref|.
* On CPU tensors the wrappers take the twins and launch nothing; the probe
  function runs end to end.
* A numpy emulation of P2's tensor-core tile algorithm (rank min/max, the
  window-or-fallback choice at a small window, K padding, the tap and
  k-step order) equals P2's Pallas body to one bfloat16 ulp on sorted and
  shuffled ranks, and the twin on ragged tiles and out-of-range ranks (read
  as zero rows). The twin equals the reference's xla expression at C = 8,
  16 and 32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mopa_tpu_torch.ops import gather
from mopa_tpu_torch.ops import sparse_conv_cuda as scc
from mopa_tpu_torch.tools import gather_micro

S, V, C, COUT = 2, 256, 16, 16


@pytest.fixture(scope="module")
def inputs():
    return gather_micro.make_inputs(S, V, C, COUT, device="cpu")


def _jax(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _specs(*extra, c=C):
    return [pl.BlockSpec((1, V, 3 * c), lambda s: (s, 0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((1, V * 8), lambda s: (s, 0),
                         memory_space=pltpu.VMEM), *extra]


def _p1_pallas(f, r):
    """``tools/gather_micro.py:83-104`` with the per-sample ``[0]``
    indexing, in interpret mode."""
    def kern(f_ref, r_ref, o_ref):
        tab = f_ref[0]                       # (V, 3C)
        idx = r_ref[0]                       # (V*8,)
        o_ref[0] = jnp.take(tab, idx, axis=0)

    return pl.pallas_call(
        kern, grid=(S,), in_specs=_specs(),
        out_specs=pl.BlockSpec((1, V * 8, 3 * C), lambda s: (s, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((S, V * 8, 3 * C), jnp.bfloat16),
        interpret=True)(f, r)


def _p2_pallas(f, r, w, c=C):
    """``tools/gather_micro.py:124-149`` as written, in interpret mode."""
    def kern(f_ref, r_ref, w_ref, o_ref):
        tab = f_ref[0]                        # (V, 3C)
        idx = r_ref[0]                        # (V*8,)
        g = jnp.take(tab, idx, axis=0)        # (V*8, 3C)
        a = g.reshape(V, 24 * c)
        o_ref[0] = jnp.dot(a, w_ref[:],
                           preferred_element_type=jnp.float32
                           ).astype(jnp.bfloat16)

    return pl.pallas_call(
        kern, grid=(S,),
        in_specs=_specs(pl.BlockSpec((24 * c, COUT), lambda s: (0, 0),
                                     memory_space=pltpu.VMEM), c=c),
        out_specs=pl.BlockSpec((1, V, COUT), lambda s: (s, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((S, V, COUT), jnp.bfloat16),
        interpret=True)(f, r, w)


def test_inputs_follow_the_reference_draws(inputs):
    tab, idx, w = inputs
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(S, V, 3 * C)).astype(np.float32)
    ranks = np.sort(rng.integers(0, V, size=(S, V * 8)), axis=1)
    weight = rng.normal(size=(24 * C, COUT)).astype(np.float32)
    np.testing.assert_array_equal(
        tab.float().numpy(), _np(jnp.asarray(feats).astype(jnp.bfloat16)))
    np.testing.assert_array_equal(idx.numpy(), ranks)
    np.testing.assert_array_equal(
        w.float().numpy(), _np(jnp.asarray(weight).astype(jnp.bfloat16)))
    assert (np.diff(idx.numpy(), axis=1) >= 0).all()


def test_p1_twin_matches_xla_gather_and_pallas_body(inputs):
    tab, idx, _ = inputs
    got = gather.row_gather_plain(tab, idx).float().numpy()
    f, r = _jax(tab), _jax(idx)
    flat_f = f.reshape(S * V, 3 * C)
    off = (jnp.arange(S, dtype=jnp.int32) * V)[:, None]
    xla = flat_f[(r + off).reshape(-1)].reshape(S, V * 8, 3 * C)
    np.testing.assert_array_equal(got, _np(xla))
    np.testing.assert_array_equal(got, _np(_p1_pallas(f, r)))


def test_reference_p1_body_as_written_fails(inputs):
    """``tools/gather_micro.py:83-87`` reads the whole (1, V, 3C) block, so
    its take is (1, V*8, V, 3C) and cannot be stored (ROADMAP Queue 3)."""
    def kern(f_ref, r_ref, o_ref):
        tab = f_ref[:]
        idx = r_ref[:]
        g = jnp.take(tab, idx, axis=0)
        o_ref[:] = g

    tab, idx, _ = inputs
    with pytest.raises(ValueError, match="Invalid shape"):
        pl.pallas_call(
            kern, grid=(S,), in_specs=_specs(),
            out_specs=pl.BlockSpec((1, V * 8, 3 * C), lambda s: (s, 0, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((S, V * 8, 3 * C), jnp.bfloat16),
            interpret=True)(_jax(tab), _jax(idx))


def test_p2_twin_matches_pallas_body(inputs):
    tab, idx, w = inputs
    got = gather.gather_gemm_plain(tab, idx, w)
    assert got.dtype == torch.bfloat16 and got.shape == (S, V, COUT)
    ref = _np(_p2_pallas(_jax(tab), _jax(idx), _jax(w)))
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= 2 ** -7 * np.abs(ref).max(), err


def test_wrappers_take_the_twins_on_cpu(inputs):
    tab, idx, w = inputs
    scc.reset_launch_counts()
    assert torch.equal(gather.row_gather(tab, idx),
                       gather.row_gather_plain(tab, idx))
    assert torch.equal(gather.gather_gemm(tab, idx, w),
                       gather.gather_gemm_plain(tab, idx, w))
    assert scc.launches[gather.P1] == scc.launches[gather.P2] == 0


def test_probe_runs_on_cpu():
    res = gather_micro.run_probes(n=2, s=S, v=V, c=C, cout=COUT,
                                  device="cpu")
    assert res["device"] == "cpu"
    assert res["gather"]["bit_exact"] and res["fused"]["max_abs_err"] == 0
    assert res["gather"]["bound_by"] == res["fused"]["bound_by"] == "bytes"
    assert res["gather"]["bound_share"] is None   # no card, no share
    # bytes: each table row the ranks read, the ranks, the output, once
    idx = gather_micro.make_inputs(S, V, C, COUT, "cpu")[1].numpy()
    used = sum(np.unique(row).size for row in idx)
    rows = S * V * 8
    assert res["gather"]["bytes"] == (used + rows) * 3 * C * 2 + rows * 4
    assert res["fused"]["bytes"] == used * 3 * C * 2 + rows * 4 \
        + S * V * COUT * 2 + 24 * C * COUT * 2
    assert res["fused"]["flops"] == 2 * S * V * 24 * C * COUT
    lines = gather_micro.report_lines(res)
    assert len(lines) == 4 and "not measured" in lines[2]


# -- P2's tensor-core tile algorithm (csrc/gather_micro.cu,
# gather_gemm_tc_kernel), emulated in numpy

ROUND_TAPS = gather.WINDOW_ROWS // gather.TILE_M   # fallback taps per round


def _taps_per_warp(d):
    """The taps whose B fragments one warp holds (P2Shape::kTQ): 4 while a
    tap takes at most 3 k-steps (D <= 48), else 2."""
    return 4 if -(-d // 16) <= 3 else 2


def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _emulate_p2(tab, idx, w, window_rows):
    """P2's kernel, tile by tile: per TILE_M output rows, the min/max of the
    in-range ranks; a window of table rows [lo, hi] when the span fits
    ``window_rows``, else the fallback's staged rows (ROUND_TAPS taps per
    round); A rows read 8 lanes at a time per 16-deep k-step, from the zero
    row where a rank is out of range or past D (K padding); f32 sums in tap,
    then k-step order within each group of ``_taps_per_warp`` taps, the
    groups' sums added in group order; a bfloat16 result. Returns (out, lo,
    hi, fits)."""
    tab, w, idx = tab.float().numpy(), w.float().numpy(), idx.numpy()
    n_s, v, d = tab.shape
    m = idx.shape[1] // gather.TAPS
    ksn = -(-d // 16)                      # 16-deep k-steps per tap
    kd = 16 * ksn
    tq = _taps_per_warp(d)
    lanes = kd                             # a buffer row's lanes
    w_pad = np.zeros((gather.TAPS, kd, COUT), np.float32)
    w_pad[:, :d] = w.reshape(gather.TAPS, d, COUT)
    zero = np.zeros(lanes + kd, np.float32)
    n_t = -(-m // gather.TILE_M)
    out = np.zeros((n_s, m, COUT), np.float32)
    lo_all = np.zeros((n_s, n_t), np.int64)
    hi_all = np.zeros((n_s, n_t), np.int64)
    fits_all = np.zeros((n_s, n_t), bool)
    for s in range(n_s):
        for t in range(n_t):
            r0 = t * gather.TILE_M
            rows = min(gather.TILE_M, m - r0)
            ranks = idx[s, gather.TAPS * r0:gather.TAPS * (r0 + rows)]
            ranks = ranks.reshape(rows, gather.TAPS)
            ok = (ranks >= 0) & (ranks < v)
            lo = ranks[ok].min() if ok.any() else np.iinfo(np.int32).max
            hi = ranks[ok].max() if ok.any() else np.iinfo(np.int32).min
            fits = hi < lo or hi - lo < window_rows
            lo_all[s, t], hi_all[s, t], fits_all[s, t] = lo, hi, fits
            buf = np.zeros((max(window_rows, gather.WINDOW_ROWS), lanes),
                           np.float32)
            if fits and hi >= lo:
                buf[:hi - lo + 1, :d] = tab[s, lo:hi + 1]

            def a_row(r, j):
                if fits:
                    src = buf[ranks[r, j] - lo] if ok[r, j] else zero
                else:
                    src = buf[(j % ROUND_TAPS) * gather.TILE_M + r]
                a = np.zeros(kd, np.float32)
                for ks in range(ksn):
                    for half in range(2):
                        k0 = 16 * ks + 8 * half
                        if k0 >= d:       # the padded K half: the zero row
                            continue
                        a[k0:k0 + 8] = src[k0:k0 + 8]
                return a

            acc = np.zeros((gather.TAPS // tq, rows, COUT), np.float32)
            for j0 in range(0, gather.TAPS, ROUND_TAPS):
                if not fits:    # stage this round's taps, zero where absent
                    buf[:] = 0
                    for jj in range(ROUND_TAPS):
                        for r in range(rows):
                            if ok[r, j0 + jj]:
                                buf[jj * gather.TILE_M + r, :d] = \
                                    tab[s, ranks[r, j0 + jj]]
                for j in range(j0, j0 + ROUND_TAPS):
                    a = np.stack([a_row(r, j) for r in range(rows)])
                    for ks in range(ksn):
                        k = slice(16 * ks, 16 * ks + 16)
                        acc[j // tq] += a[:, k] @ w_pad[j, k]
            total = acc[0]
            for part in acc[1:]:
                total = total + part
            out[s, r0:r0 + rows] = _bf16(total)
    return out, lo_all, hi_all, fits_all


def _shuffled(idx, seed=1):
    rng = np.random.default_rng(seed)
    r = idx.numpy().copy()
    for row in r:
        rng.shuffle(row)
    return torch.from_numpy(r)


@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("c", [8, 16])
def test_p2_tile_emulation_matches_pallas_body(c, order):
    """D = 3C = 24 pads K to 32 (one zero half-step per tap); 48 does not.
    At a 160-row window the sorted ranks' tiles (spans of ~128 rows) take
    windows and the shuffled ones (spans of ~V) the fallback."""
    tab, idx, w = gather_micro.make_inputs(S, V, c, COUT, device="cpu")
    if order == "shuffled":
        idx = _shuffled(idx)
    got, lo, hi, fits = _emulate_p2(tab, idx, w, window_rows=160)
    want_lo, want_hi, want_fits = gather.tile_windows(idx, V, 160)
    np.testing.assert_array_equal(lo, want_lo.numpy())
    np.testing.assert_array_equal(hi, want_hi.numpy())
    np.testing.assert_array_equal(fits, want_fits.numpy())
    assert fits.all() if order == "sorted" else not fits.any()
    ref = _np(_p2_pallas(_jax(tab), _jax(idx), _jax(w), c=c))
    err = np.abs(got - ref).max()
    assert err <= 2 ** -7 * np.abs(ref).max(), err


@pytest.mark.parametrize("d,window_rows", [(8, 64), (8, 4096), (40, 4096),
                                           (128, 96)])
def test_p2_tile_emulation_on_ragged_tiles_and_bad_ranks(d, window_rows):
    """M = 300 (the last tile 44 rows), sorted ranks of which a few lie
    outside [0, V): the emulation equals the twin, which reads those ranks
    as zero rows, in window and fallback tiles alike."""
    s, v, m = 2, 500, 300
    rng = np.random.default_rng(3)
    tab = torch.from_numpy(rng.normal(size=(s, v, d)).astype(np.float32)
                           ).to(torch.bfloat16)
    ranks = np.sort(rng.integers(0, v, size=(s, m * gather.TAPS)), axis=1)
    bad = rng.choice(m * gather.TAPS, size=40, replace=False)
    ranks[0, bad[:20]] = -1 - rng.integers(0, 5, size=20)
    ranks[1, bad[20:]] = v + rng.integers(0, 5, size=20)
    idx = torch.from_numpy(ranks.astype(np.int32))
    w = torch.from_numpy(rng.normal(size=(gather.TAPS * d, COUT)).astype(
        np.float32)).to(torch.bfloat16)
    got, lo, hi, fits = _emulate_p2(tab, idx, w, window_rows)
    assert fits.all() if window_rows > v else not fits.all()
    assert lo.min() >= 0 and hi.max() < v
    ref = gather.gather_gemm_plain(tab, idx, w).float().numpy()
    assert got.shape == ref.shape == (s, m, COUT)
    err = np.abs(got - ref).max()
    assert err <= 2 ** -7 * np.abs(ref).max(), err


@pytest.mark.parametrize("wrapper", ["row_gather", "gather_gemm"])
def test_wrappers_read_out_of_range_ranks_as_zero_rows(wrapper):
    """On CPU tensors both wrappers run their twins, which read a rank
    outside [0, V) (negative or past the table) as a zero row, as the CUDA
    kernels do: the result equals the one on the table with a zero row
    appended and those ranks pointed at it."""
    s, v, d, m = 2, 40, 16, 24
    rng = np.random.default_rng(4)
    tab = torch.from_numpy(rng.normal(size=(s, v, d)).astype(np.float32)
                           ).to(torch.bfloat16)
    ranks = rng.integers(0, v, size=(s, m * gather.TAPS))
    ranks[0, :5] = [-1, -7, v, v + 3, 2 * v]
    ranks[1, -3:] = [-v, v + 1, -2]
    idx = torch.from_numpy(ranks.astype(np.int32))
    tab0 = torch.cat([tab, tab.new_zeros((s, 1, d))], dim=1)
    idx0 = torch.where((idx >= 0) & (idx < v), idx, torch.full_like(idx, v))
    if wrapper == "row_gather":
        got, want = gather.row_gather(tab, idx), gather.row_gather(tab0, idx0)
    else:
        w = torch.from_numpy(rng.normal(size=(gather.TAPS * d, COUT)).astype(
            np.float32)).to(torch.bfloat16)
        got = gather.gather_gemm(tab, idx, w)
        want = gather.gather_gemm(tab0, idx0, w)
    assert torch.equal(got, want)


def test_tile_windows_spans():
    """Per tile: min/max over in-range ranks of its rows only; a tile with
    no rank in range fits (no window rows); the span rule is hi - lo <
    window_rows."""
    m, v = 2 * gather.TILE_M + 5, 1000
    idx = torch.full((1, m * gather.TAPS), -3, dtype=torch.int32)
    idx[0, 0] = 7
    idx[0, gather.TAPS * gather.TILE_M - 1] = 7 + 99    # tile 0: span 100
    idx[0, gather.TAPS * gather.TILE_M] = v             # tile 1: none in
    idx[0, -1] = 500                                    # tile 2: one rank
    lo, hi, fits = gather.tile_windows(idx, v, window_rows=100)
    assert lo[0, 0] == 7 and hi[0, 0] == 106 and bool(fits[0, 0])
    assert hi[0, 1] < lo[0, 1] and bool(fits[0, 1])
    assert lo[0, 2] == hi[0, 2] == 500 and bool(fits[0, 2])
    assert not bool(gather.tile_windows(idx, v, window_rows=99)[2][0, 0])


@pytest.mark.parametrize("c", [8, 16, 32])
def test_p2_twin_matches_reference_expression(c):
    """The twin against the reference's expression at (S, V, 3C): the flat
    xla gather, the (V, 24C) reshape and the float32-accumulated dot."""
    tab, idx, w = gather_micro.make_inputs(S, V, c, COUT, device="cpu")
    got = gather.gather_gemm_plain(tab, idx, w).float().numpy()
    f, r = _jax(tab), _jax(idx)
    flat_f = f.reshape(S * V, 3 * c)
    off = (jnp.arange(S, dtype=jnp.int32) * V)[:, None]
    a = flat_f[(r + off).reshape(-1)].reshape(S, V, 24 * c)
    ref = _np(jnp.dot(a, _jax(w), preferred_element_type=jnp.float32
                      ).astype(jnp.bfloat16))
    err = np.abs(got - ref).max()
    assert err <= 2 ** -7 * np.abs(ref).max(), err
