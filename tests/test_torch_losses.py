"""The port's lasso and logistic losses against the reference's.

Inputs are made with numpy from a seed and handed to both packages
(JAX on the CPU).  ``prox_setup``, ``prox_apply`` and ``node_values``
agree within atol 1e-5 (the inner loops run 30 ISTA / 8 Newton steps in
float32, summed in each framework's own order); ``_chol_solve`` agrees
with ``torch.linalg.solve``; ``prox_apply`` with a leading block axis
(the fused plain version's windows) equals a per-block loop; and the
squared loss hands the ``batched_affine`` kernel a row-major p.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api.losses import (LassoLoss, LogisticLoss,  # noqa: E402
                                    _chol_solve)
from repro_torch.core.losses import NodeData                 # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
V = 37


def _data(m, n, seed, logistic):
    """Node data with a few padded samples and ~60% labeled nodes."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((V, m, n)).astype(np.float32)
    if logistic:
        y = (rng.random((V, m)) < 0.5).astype(np.float32)
    else:
        y = rng.standard_normal((V, m)).astype(np.float32)
    mask = (rng.random((V, m)) < 0.85).astype(np.float32)
    mask[:, 0] = 1.0
    labeled = (rng.random(V) < 0.6).astype(np.float32)
    tau = (1.0 / rng.integers(1, 9, size=V)).astype(np.float32)
    v = (2.0 * rng.standard_normal((V, n))).astype(np.float32)
    w = rng.standard_normal((V, n)).astype(np.float32)
    return (x, y, mask, labeled), tau, v, w


def _losses(kind):
    from repro.api import losses as jl
    if kind == "lasso":
        kw = dict(alpha=0.02, num_inner=30)
        return LassoLoss(**kw), jl.LassoLoss(**kw)
    return LogisticLoss(), jl.LogisticLoss()


CASES = [(kind, m, n) for kind in ("lasso", "logistic")
         for m in (3, 8) for n in (2, 4)]


@pytest.mark.parametrize("kind,m,n", CASES)
def test_loss_matches_reference(kind, m, n):
    import jax.numpy as jnp
    from repro.core.losses import NodeData as JNodeData

    arrays, tau, v, w = _data(m, n, seed=10 * m + n,
                              logistic=kind == "logistic")
    loss, jloss = _losses(kind)
    tdata = NodeData(*(torch.from_numpy(a) for a in arrays))
    jdata = JNodeData(*(jnp.asarray(a) for a in arrays))

    params = loss.prox_setup(tdata, torch.from_numpy(tau))
    jparams = jloss.prox_setup(jdata, jnp.asarray(tau))
    assert sorted(params) == sorted(jparams)
    for k in params:
        assert params[k].ndim >= 2 and params[k].shape[0] == V, k
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jparams[k]),
                                   err_msg=k, **TOL)
    got = loss.prox_apply(params, torch.from_numpy(v))
    want = jloss.prox_apply(jparams, jnp.asarray(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        loss.node_values(tdata, torch.from_numpy(w)).numpy(),
        np.asarray(jloss.node_values(jdata, jnp.asarray(w))), **TOL)
    assert loss.prox_param_floats(m, n) == jloss.prox_param_floats(m, n)


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_chol_solve_matches_linalg_solve(n):
    rng = np.random.default_rng(n)
    g = rng.standard_normal((V, n, n))
    a = torch.from_numpy((g @ g.transpose(0, 2, 1)
                          + n * np.eye(n)).astype(np.float32))
    rhs = torch.from_numpy(rng.standard_normal((V, n)).astype(np.float32))
    want = torch.linalg.solve(a, rhs)
    np.testing.assert_allclose(_chol_solve(a, rhs).numpy(), want.numpy(),
                               **TOL)
    # a leading block axis rides along
    got = _chol_solve(a.reshape(1, V, n, n), rhs.reshape(1, V, n))
    np.testing.assert_allclose(got[0].numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("kind", ["lasso", "logistic"])
def test_prox_apply_with_block_axis_equals_per_block_loop(kind):
    """The fused plain version hands prox_apply (B, NW, ...) windows."""
    arrays, tau, v, _ = _data(4, 3, seed=5, logistic=kind == "logistic")
    loss, _ = _losses(kind)
    tdata = NodeData(*(torch.from_numpy(a) for a in arrays))
    params = loss.prox_setup(tdata, torch.from_numpy(tau))
    blocks, nw = 3, 12                      # 36 of the 37 nodes, 3 windows
    stacked = {k: a[:blocks * nw].reshape((blocks, nw) + a.shape[1:])
               for k, a in params.items()}
    tv = torch.from_numpy(v[:blocks * nw]).reshape(blocks, nw, -1)
    got = loss.prox_apply(stacked, tv)
    for b in range(blocks):
        one = {k: a[b] for k, a in stacked.items()}
        assert torch.equal(got[b], loss.prox_apply(one, tv[b]))


def test_squared_prox_matrix_is_row_major(monkeypatch):
    """The batched inverse on CUDA returns column-major matrices; the
    ``batched_affine`` kernel reads p row-major and refuses anything
    else, so ``prox_setup`` hands it a contiguous p whatever the layout
    of the inverse (emulated here on the CPU)."""
    from repro_torch.api.losses import SquaredLoss

    import types

    arrays, tau, _, _ = _data(5, 3, seed=2, logistic=False)
    tdata = NodeData(*(torch.from_numpy(a) for a in arrays))
    want = SquaredLoss().prox_setup(tdata, torch.from_numpy(tau))["p"]
    inv_ex = torch.linalg.inv_ex

    def column_major_inv_ex(a):
        out = inv_ex(a)
        return types.SimpleNamespace(inverse=out.inverse.mT.contiguous().mT,
                                     info=out.info)

    # prox_setup inverts with inv_ex (no host-side check of the info code)
    monkeypatch.setattr(torch.linalg, "inv_ex", column_major_inv_ex)
    assert not torch.linalg.inv_ex(
        torch.eye(3)[None]).inverse.is_contiguous()
    p = SquaredLoss().prox_setup(tdata, torch.from_numpy(tau))["p"]
    assert p.is_contiguous()
    assert torch.equal(p, want)


def test_lasso_setup_batches_the_eigensolve(monkeypatch):
    """The lasso's set-up takes lambda_max(Q) in batches of
    ``EIGVALSH_BATCH`` nodes (cuSOLVER refuses batches of 32768 and
    more); the batches give the parameters of one call."""
    from repro_torch.api import losses

    arrays, tau, _, _ = _data(3, 4, seed=7, logistic=False)
    tdata = NodeData(*(torch.from_numpy(a) for a in arrays))
    loss = LassoLoss(alpha=0.02, num_inner=30)
    want = loss.prox_setup(tdata, torch.from_numpy(tau))
    monkeypatch.setattr(losses, "EIGVALSH_BATCH", 5)       # 8 batches of 37
    got = loss.prox_setup(tdata, torch.from_numpy(tau))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
