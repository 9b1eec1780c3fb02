"""The port's legacy surface on the card (``-m cuda``; each test skips
without a CUDA device).  No JAX here: the card's machine has none, so
these compare with the port's own plain versions and the CPU.

  * ``nlasso`` with the port's kernels as its hooks equals the unfused
    pallas solve bit for bit, each kernel launched once a step; the
    certificate launches ``sym_pinv``,
  * FedTV's ``pd_update`` on the card within 1e-5 of the same steps on
    the CPU, every dual within its bound,
  * the Table-1 baselines on the card's data equal the CPU's.

The CPU tests of this surface against the reference are in
``test_torch_nlasso.py`` and ``test_torch_fedtv.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import Problem, Solver, SolverConfig, certificate  # noqa
from repro_torch.core import baselines, fedtv                # noqa: E402
from repro_torch.core.nlasso import (nlasso,                 # noqa: E402
                                     primal_dual_gap_certificate)
from repro_torch.data.synthetic import make_sbm_regression   # noqa: E402
from repro_torch.kernels import ops                          # noqa: E402

SBM = dict(seed=0, cluster_sizes=(40, 40), p_in=0.5, p_out=1e-3,
           num_labeled=16)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_nlasso_kernel_hooks_equal_unfused_pallas(card):
    from repro_torch.kernels.ridge_prox import batched_affine
    from repro_torch.kernels.sym_pinv import sym_pinv
    from repro_torch.kernels.tv_prox import tv_prox

    ds = make_sbm_regression(**SBM, device=card)
    tv_prox.launches = batched_affine.launches = 0
    got = nlasso(ds.graph, ds.data, 1e-3, num_iters=50, rho=1.9,
                 affine_fn=ops.batched_affine, clip_fn=ops.tv_prox)
    torch.cuda.synchronize()
    assert tv_prox.launches == 50 and batched_affine.launches == 50
    problem = Problem.create(ds.graph, ds.data, 1e-3, device=card)
    want = Solver(SolverConfig(backend="pallas", fused=False, num_iters=50,
                               rho=1.9)).run(problem)
    assert torch.equal(got.w, want.w) and torch.equal(got.u, want.u)
    assert torch.equal(got.objective, want.objective)
    sym_pinv.launches = 0       # each solve's diagnostics launched it too
    cert = primal_dual_gap_certificate(ds.graph, ds.data, got.w, got.u,
                                       1e-3)
    assert sym_pinv.launches == 1
    ref = certificate(problem, got.w, got.u)
    assert all(torch.equal(cert[k], ref[k]) for k in ref)


@pytest.mark.cuda
def test_fedtv_pd_update_matches_cpu(card):
    cfg = fedtv.FedTVConfig(num_clients=32, lam=1e-2)
    dev = fedtv.init_state(cfg, 256, device=card)
    cpu = fedtv.init_state(cfg, 256, device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(50):
        g = torch.from_numpy(rng.standard_normal((32, 256)).astype(
            np.float32))
        dev = fedtv.pd_update(dev, g.to(card), cfg)
        cpu = fedtv.pd_update(cpu, g, cfg)
    for k in ("delta", "dual"):
        assert float((dev[k].cpu() - cpu[k]).abs().max()) <= 1e-5, k
    bound = cfg.lam * dev["graph"].weights[:, None]
    assert bool((dev["dual"].abs() <= bound + 1e-6).all())


@pytest.mark.cuda
def test_baselines_on_card_data_equal_cpu(card):
    ds = make_sbm_regression(**SBM, device=card)
    cpu = ds.data.to("cpu")
    w = baselines.pooled_linear_regression(ds.data)
    np.testing.assert_array_equal(w, baselines.pooled_linear_regression(cpu))
    for on in ("train", "test", "all"):
        assert baselines.linreg_mse(ds.data, w, on) == \
            baselines.linreg_mse(cpu, w, on)
        assert baselines.decision_tree_mse(ds.data, on) == \
            baselines.decision_tree_mse(cpu, on)
