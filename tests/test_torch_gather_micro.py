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


def _specs(*extra):
    return [pl.BlockSpec((1, V, 3 * C), lambda s: (s, 0, 0),
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


def _p2_pallas(f, r, w):
    """``tools/gather_micro.py:124-149`` as written, in interpret mode."""
    def kern(f_ref, r_ref, w_ref, o_ref):
        tab = f_ref[0]                        # (V, 3C)
        idx = r_ref[0]                        # (V*8,)
        g = jnp.take(tab, idx, axis=0)        # (V*8, 3C)
        a = g.reshape(V, 24 * C)
        o_ref[0] = jnp.dot(a, w_ref[:],
                           preferred_element_type=jnp.float32
                           ).astype(jnp.bfloat16)

    return pl.pallas_call(
        kern, grid=(S,),
        in_specs=_specs(pl.BlockSpec((24 * C, COUT), lambda s: (0, 0),
                                     memory_space=pltpu.VMEM)),
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
