"""The port's FedTV personalization (``repro_torch.core.fedtv``) and
Table-1 baselines (``repro_torch.core.baselines``) against the
reference's, on the CPU.

  * the reference's four ``tests/test_fedtv.py`` tests, on the port,
  * ``make_client_graph`` bit-equal to the reference's for both graph
    kinds, and 20 ``pd_update`` steps within 1e-6 of
    ``repro.core.fedtv``'s on gradients drawn from one numpy seed,
  * the baselines (pooled least squares, its MSE, the CART tree's
    predictions and MSE) equal to the reference's bit for bit, on data
    made on the port's side.

The card's tests of FedTV are in ``test_torch_legacy_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import baselines as jb                       # noqa: E402
from repro.core import fedtv as jf                           # noqa: E402
from repro.data.synthetic import make_sbm_regression as j_sbm  # noqa: E402
from repro_torch.core import baselines                       # noqa: E402
from repro_torch.core import fedtv                           # noqa: E402
from repro_torch.data.synthetic import make_sbm_regression   # noqa: E402

GRAPH_FIELDS = ("src", "dst", "weights", "inc_edges", "inc_signs")


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# the reference's tests/test_fedtv.py, on the port
# ---------------------------------------------------------------------------

def test_client_ids_contiguous_groups():
    ids = fedtv.client_ids(16, 4, device="cpu").tolist()
    assert ids == [0] * 4 + [1] * 4 + [2] * 4 + [3] * 4


def test_apply_gain_identity_at_zero():
    delta = torch.zeros((4, 8))
    h = torch.from_numpy(_normal(0, (8, 3, 8)))
    ids = fedtv.client_ids(8, 4, device="cpu")
    assert torch.equal(fedtv.apply_gain(h, delta, ids), h)


def test_pd_update_respects_dual_bound():
    cfg = fedtv.FedTVConfig(num_clients=8, lam=1e-2)
    state = fedtv.init_state(cfg, d_model=16, device="cpu")
    g = torch.from_numpy(_normal(1, (8, 16)))
    for _ in range(5):
        state = fedtv.pd_update(state, g, cfg)
    bound = cfg.lam * state["graph"].weights.numpy()[:, None]
    assert (np.abs(state["dual"].numpy()) <= bound + 1e-6).all()


def test_tv_coupling_pulls_clients_together():
    """Clients with identical grads but different starts converge toward a
    shared profile inside a cluster (statistical-strength sharing)."""
    cfg = fedtv.FedTVConfig(num_clients=8, lam=1.0, prox_lr=0.0,
                            graph_kind="chain")
    state = fedtv.init_state(cfg, d_model=4, device="cpu")
    state["delta"] = torch.from_numpy(_normal(0, (8, 4)))
    tv0 = float(fedtv.tv_value(state))
    zeros = torch.zeros((8, 4))
    for _ in range(300):
        state = fedtv.pd_update(state, zeros, cfg)
    tv1 = float(fedtv.tv_value(state))
    assert tv1 < 0.2 * tv0, (tv0, tv1)


# ---------------------------------------------------------------------------
# against repro.core.fedtv
# ---------------------------------------------------------------------------

CONFIGS = {
    "clusters16": dict(),
    "clusters32_3": dict(num_clients=32, num_clusters=3, seed=4),
    "chain": dict(num_clients=12, graph_kind="chain", lam=0.5),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_client_graph_bit_equal_to_reference(name):
    got = fedtv.make_client_graph(fedtv.FedTVConfig(**CONFIGS[name]),
                                  device="cpu")
    want = jf.make_client_graph(jf.FedTVConfig(**CONFIGS[name]))
    assert got.num_nodes == want.num_nodes
    for f in GRAPH_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_pd_update_matches_reference(name):
    import jax.numpy as jnp

    d = 24
    cfg = fedtv.FedTVConfig(**CONFIGS[name])
    jcfg = jf.FedTVConfig(**CONFIGS[name])
    state = fedtv.init_state(cfg, d_model=d, device="cpu")
    jstate = jf.init_state(jcfg, d_model=d)
    rng = np.random.default_rng(5)
    for _ in range(20):
        grad = rng.standard_normal((cfg.num_clients, d)).astype(np.float32)
        state = fedtv.pd_update(state, torch.from_numpy(grad), cfg)
        jstate = jf.pd_update(jstate, jnp.asarray(grad), jcfg)
    for k in ("delta", "dual"):
        np.testing.assert_allclose(state[k].numpy(), np.asarray(jstate[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(fedtv.tv_value(state)),
                               float(jf.tv_value(jstate)), rtol=1e-6)


def test_apply_gain_and_ids_match_reference():
    import jax.numpy as jnp

    delta = _normal(2, (4, 8))
    h = _normal(3, (12, 3, 8))
    ids = fedtv.client_ids(12, 4, device="cpu")
    np.testing.assert_array_equal(ids.numpy(),
                                  np.asarray(jf.client_ids(12, 4)))
    got = fedtv.apply_gain(torch.from_numpy(h), torch.from_numpy(delta), ids)
    want = jf.apply_gain(jnp.asarray(h), jnp.asarray(delta),
                         jf.client_ids(12, 4))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_state_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        fedtv.init_state(fedtv.FedTVConfig(), d_model=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        fedtv.client_ids(8, 2)


# ---------------------------------------------------------------------------
# Table-1 baselines against repro.core.baselines, bit for bit
# ---------------------------------------------------------------------------

SBM = dict(seed=0, cluster_sizes=(40, 40), p_in=0.5, p_out=1e-3,
           num_labeled=16)


@pytest.fixture(scope="module")
def pair():
    return make_sbm_regression(**SBM, device="cpu"), j_sbm(**SBM)


def test_pooled_linear_regression_bit_equal(pair):
    ds, jds = pair
    w = baselines.pooled_linear_regression(ds.data)
    jw = jb.pooled_linear_regression(jds.data)
    np.testing.assert_array_equal(w, jw)
    for on in ("train", "test", "all"):
        assert (baselines.linreg_mse(ds.data, w, on)
                == jb.linreg_mse(jds.data, jw, on)), on


@pytest.mark.parametrize("max_depth", [2, 8])
def test_decision_tree_bit_equal(pair, max_depth):
    ds, jds = pair
    x, y = baselines._pool(ds.data)
    jx, jy = jb._pool(jds.data)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    tree = baselines.DecisionTreeRegressor(max_depth=max_depth).fit(x, y)
    jtree = jb.DecisionTreeRegressor(max_depth=max_depth).fit(jx, jy)
    assert tree._nodes == jtree._nodes
    xall = ds.data.x.numpy().reshape(-1, ds.data.x.shape[-1])
    np.testing.assert_array_equal(tree.predict(xall), jtree.predict(xall))
    for on in ("train", "test", "all"):
        assert (baselines.decision_tree_mse(ds.data, on, max_depth)
                == jb.decision_tree_mse(jds.data, on, max_depth)), on


def test_pool_unlabeled_too_bit_equal(pair):
    ds, jds = pair
    for got, want in zip(baselines._pool(ds.data, labeled_only=False),
                         jb._pool(jds.data, labeled_only=False)):
        np.testing.assert_array_equal(got, want)
