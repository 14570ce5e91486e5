"""K1 and K2 at output widths above 192 channels: the column blocks of
``ops/sparse_conv_cuda.py`` on the CPU.

The kernels hold at most ``COUT_MAX`` (192) output columns per launch
(``kCoutMax`` in ``csrc/``), so a wider output runs as near-equal column
blocks, one launch each, on a packed slice of the weight (``d_w``: of the
cotangent), stitched by ``torch.cat``. Here the library launch is stubbed
by the plain twin applied to exactly the arguments a launch receives (a
float32 launch: by the emulation of its 3xTF32 sums over the pair lists
and span table it is given and the weight pack it writes into its
scratch, ``test_torch_conv_f32_tc``), so the slicing, the packing and the
stitching are held:

* at SPVCNN's shapes (Cin 384 -> Cout 256, and 128 -> 256): K1,
  ``d_feats`` and ``d_w`` equal the unblocked twin (float32 to 1e-5 of the
  largest |value|, bfloat16 to 2e-2) and, in float32, JAX's
  ``sparse_conv.submanifold_conv_wide`` with its ``jax.vjp`` to 1e-5, on
  both routes' argument lists;
* launches per call equal the blocks (256 -> 2 x 128, 384 -> 2 x 192), and
  a width of at most 192 takes exactly one launch with the weight passed in
  place.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mopa_tpu.ops import sparse_conv as jsc
from mopa_tpu_torch.ops import sparse_conv as psc
from mopa_tpu_torch.ops import sparse_conv_cuda as scc

from test_torch_conv_f32_tc import (emulate_conv_3xtf32, emulate_dw_3xtf32,
                                    twin_pair_lists)
from test_torch_conv_tc_layout import level  # noqa: F401 (fixture)

torch.set_num_threads(1)


def _close(got, want, rel=1e-5):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=rel * max(1.0, np.abs(want).max()))


@pytest.fixture
def twin_launches(monkeypatch):
    """Route every library launch to the plain twin of its kernel, recording
    (kernel, route, the launch's tensor and integer arguments); the float32
    route's pair lists and span table are the twins'."""
    calls = []

    def launch(kernel, route, fn, device, *args):
        if route == scc.TF32X3 and kernel != scc.K2_DW:
            # the scratch the launch packs its weight into, then sums in
            # 3xTF32 from; recorded without it
            pack = args[4]
            args = args[:4] + args[5:]
        calls.append((kernel, route, args))
        scc.launches[kernel] += 1
        scc.routes[kernel][route] += 1
        if kernel == scc.K2_DW:
            # the plan (bfloat16) or the pair lists (float32)
            feats, g, plan_a, plan_b, partial, out = args[:6]
            v, cin, cout = args[6:9]
            assert (g.shape[1], out.shape) == (cout, (27, cin, cout))
            assert g.is_contiguous()
            if route == scc.TF32X3:
                assert partial.shape[1:] == (27, cin, cout)
                out.copy_(emulate_dw_3xtf32(g, feats, plan_a, plan_b))
            else:
                assert partial.shape[2:] == (cin, 3 * cout)
                out.copy_(psc.submanifold_conv_wide_dw_ref(g, feats, plan_a,
                                                           plan_b))
            return
        # the plan (bfloat16) or the pair lists and span table (float32)
        rows, plan_a, plan_b, weight, out, v, cin, width, mirror = args[:9]
        assert out.shape == (v, width) and weight.is_contiguous()
        if route == scc.TF32X3:
            assert args[9:] == (scc.conv_tile_shape(cin, width)[1],
                                scc.PAIR_SPAN)
            pack.copy_(scc.pair_pack_3xtf32(weight, mirror, args[9]))
            out.copy_(emulate_conv_3xtf32(rows, plan_a, plan_b, pack, width))
            return
        assert args[9:] == scc.conv_tile_shape(cin, width)
        ref = (psc.submanifold_conv_wide_dfeats_ref if mirror
               else psc.submanifold_conv_wide_ref)
        out.copy_(ref(rows, plan_a, plan_b, weight).to(out.dtype))

    monkeypatch.setattr(scc, "_require_cuda", lambda x, what: None)
    lib = type("Lib", (), {"__getattr__": lambda self, name: name})()
    monkeypatch.setattr(scc, "build", lambda: {"conv": lib, "dw": lib})
    monkeypatch.setattr(scc, "_launch", launch)
    monkeypatch.setattr(scc, "_call", twin_pair_lists)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    scc.reset_launch_counts()
    yield calls
    scc.reset_launch_counts()


def test_column_blocks():
    assert scc.column_blocks(1) == [(0, 1)]
    assert scc.column_blocks(192) == [(0, 192)]
    assert scc.column_blocks(256) == [(0, 128), (128, 256)]
    assert scc.column_blocks(384) == [(0, 192), (192, 384)]
    for width in (193, 200, 385, 1000):
        blocks = scc.column_blocks(width)
        assert blocks[0][0] == 0 and blocks[-1][1] == width
        assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
        assert all(0 < c1 - c0 <= scc.COUT_MAX for c0, c1 in blocks)
        assert all((c1 - c0) % 16 == 0 for c0, c1 in blocks[:-1])
        assert len(blocks) == -(-width // scc.COUT_MAX)


@pytest.mark.parametrize("cin,cout", [(384, 256), (128, 256)])
# the float32 id is the name the route had before 3xTF32
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["cuda-core", "tensor-core"])
def test_wide_conv_blocks_match_twin_and_jax(level, twin_launches, cin,
                                             cout, dtype):
    lv, _ = level
    v = lv.valid.shape[0]
    rng = np.random.default_rng(cin + cout)
    feats = rng.normal(size=(v, cin)).astype(np.float32)
    w = (rng.normal(size=(27, cin, cout)) * 0.05).astype(np.float32)
    g = rng.normal(size=(v, cout)).astype(np.float32)
    ft, wt, gt = (torch.from_numpy(a).to(dtype) for a in (feats, w, g))
    out = scc.submanifold_conv_wide_cuda(ft, lv.ranks, lv.sel, wt)
    d_feats = scc.submanifold_conv_wide_bwd_dfeats_cuda(gt, lv.ranks,
                                                        lv.sel, wt)
    d_w = scc.submanifold_conv_wide_bwd_dw_cuda(gt, ft, lv.ranks, lv.sel)
    assert (out.dtype, d_feats.dtype, d_w.dtype) == (dtype, dtype,
                                                     torch.float32)
    n_out, n_in = len(scc.column_blocks(cout)), len(scc.column_blocks(cin))
    route = scc.route_for(dtype)
    assert scc.launches[scc.K1] == n_out == scc.routes[scc.K1][route]
    assert scc.launches[scc.K2_DFEATS] == n_in
    assert scc.launches[scc.K2_DW] == n_out
    assert [a[2][4].shape[1] for a in twin_launches[:n_out]] == [
        c1 - c0 for c0, c1 in scc.column_blocks(cout)]
    # the unblocked twins (bfloat16: the card's rule, 2e-2 of max|ref|; the
    # twin's bfloat16 GEMM rounds by the width it is given)
    rel = 1e-5 if dtype == torch.float32 else 2e-2
    _close(out.float(), psc.submanifold_conv_wide_ref(ft, lv.ranks, lv.sel,
                                                      wt).float(), rel)
    _close(d_feats.float(), psc.submanifold_conv_wide_dfeats_ref(
        gt, lv.ranks, lv.sel, wt).float(), rel)
    _close(d_w, psc.submanifold_conv_wide_dw_ref(gt, ft, lv.ranks, lv.sel))
    if dtype != torch.float32:
        return
    wide = jsc.WidePlan(jnp.asarray(lv.ranks.numpy()),
                        jnp.asarray(lv.sel.numpy()))
    want, vjp = jax.vjp(lambda f, w_: jsc.submanifold_conv_wide(f, wide, w_),
                        jnp.asarray(feats), jnp.asarray(w))
    want_df, want_dw = vjp(jnp.asarray(g))
    _close(out, want)
    _close(d_feats, want_df)
    _close(d_w, want_dw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_narrow_widths_take_one_launch_in_place(level, twin_launches, dtype):
    """Up to 192 output columns: one launch per call, reading the forward
    weight and the cotangent in place (their own memory, not a copy)."""
    lv, _ = level
    v = lv.valid.shape[0]
    ft = torch.randn(v, 192).to(dtype)
    wt = torch.randn(27, 192, 192).to(dtype)
    gt = torch.randn(v, 192).to(dtype)
    scc.submanifold_conv_wide_cuda(ft, lv.ranks, lv.sel, wt)
    scc.submanifold_conv_wide_bwd_dfeats_cuda(gt, lv.ranks, lv.sel, wt)
    scc.submanifold_conv_wide_bwd_dw_cuda(gt, ft, lv.ranks, lv.sel)
    assert [c[0] for c in twin_launches] == [scc.K1, scc.K2_DFEATS,
                                             scc.K2_DW]
    for got, passed in ((twin_launches[0][2][3], wt),
                        (twin_launches[1][2][3], wt),
                        (twin_launches[2][2][1], gt)):
        assert (got.data_ptr(), got.shape, got.stride()) == (
            passed.data_ptr(), passed.shape, passed.stride())
    for name in (scc.K1, scc.K2_DFEATS, scc.K2_DW):
        assert scc.launches[name] == 1
