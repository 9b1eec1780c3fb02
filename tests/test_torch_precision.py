"""The port's precision policy (bf16 storage, f32 arithmetic) and fused
dispatch, against the reference's, on the CPU.

``SolverConfig.dtype="bfloat16"`` stores the fused path's state and
float prox parameters in bf16 while every sum, prox solve, resolvent and
residual runs in f32 (``kernels.ref.pd_window_step``).  Here:

  * every scenario's bf16 fused solve meets the reference's hard gates of
    ``tests/test_precision.py`` against the reference's dense f32 solve
    (final objective within 15%, ``w`` within 0.5 of its scale, after 200
    iterations), and stays close to the reference's own bf16 fused solve:
    measured on the 8 scenarios, the final ``w`` differs by at most
    1.6e-4 of its scale (a few bf16 ulps on a few nodes; 0 on five
    scenarios) and the objective trace by at most 3.5e-5 relative, so
    the limits are 1e-3 and 1e-4;
  * bf16 is refused off the fused path, naming "bfloat16", as in the
    reference; an unknown dtype raises ``ValueError``;
  * the layout's window estimate and the dispatch gate take the storage
    itemsize;
  * ``kernel_safe`` equals the reference's for every loss, and on a
    (simulated) CUDA problem the dispatch fuses every registered loss,
    but not a loss without ``prox_setup``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import Solver as JSolver                      # noqa: E402
from repro.api import SolverConfig as JConfig                # noqa: E402
from repro.api import losses as jlosses                      # noqa: E402
from repro.scenarios import get_scenario as j_get            # noqa: E402
from repro_torch.api import Problem, Solver, SolverConfig    # noqa: E402
from repro_torch.api import backends, losses                 # noqa: E402
from repro_torch.scenarios import SCENARIOS, get_scenario    # noqa: E402

CONF = dict(num_iters=200, rho=1.9, metric_every=10)
BF16 = dict(CONF, backend="pallas", fused=True, dtype="bfloat16")
BF16_OBJ_REL = 0.15          # the reference's gates (tests/test_precision.py)
BF16_W_REL = 0.5

_reference: dict = {}


def reference(name: str):
    """(reference dense f32, reference bf16 fused) solves, once each."""
    if name not in _reference:
        inst = j_get(name).build(seed=0, smoke=True)
        _reference[name] = (JSolver(JConfig(**CONF)).run(inst.problem),
                            JSolver(JConfig(**BF16)).run(inst.problem))
    return _reference[name]


def port_problem(name: str = "sbm_regression"):
    return get_scenario(name).build(seed=0, smoke=True,
                                    device="cpu").problem


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_bf16_storage_conforms(name):
    dense, ref_bf16 = reference(name)
    got = Solver(SolverConfig(**BF16)).run(port_problem(name))
    assert got.w.dtype == torch.float32 and got.u.dtype == torch.float32
    obj = got.objective.numpy()
    assert np.all(np.isfinite(obj))
    ref_obj = np.asarray(dense.objective)
    rel = float((obj[-1] - ref_obj[-1]) / abs(ref_obj[-1]))
    assert rel <= BF16_OBJ_REL, (name, rel)
    w_ref = np.asarray(dense.w)
    w_scale = float(np.abs(w_ref).max()) or 1.0
    w_rel = float(np.abs(got.w.numpy() - w_ref).max()) / w_scale
    assert w_rel <= BF16_W_REL, (name, w_rel)
    # against the reference's own bf16 fused solve
    w_b = np.asarray(ref_bf16.w)
    assert (float(np.abs(got.w.numpy() - w_b).max())
            <= 1e-3 * float(np.abs(w_b).max()))
    np.testing.assert_allclose(obj, np.asarray(ref_bf16.objective),
                               rtol=1e-4)


@pytest.mark.parametrize("path", [dict(backend="dense"),
                                  dict(backend="pallas", fused=False)])
def test_bf16_rejected_off_the_fused_path(path):
    cfg = SolverConfig(**dict(CONF, **path), dtype="bfloat16")
    with pytest.raises(NotImplementedError, match="bfloat16"):
        Solver(cfg).run(port_problem())


def test_unknown_dtype_rejected():
    for backend in ("dense", "pallas"):
        cfg = SolverConfig(**CONF, backend=backend, fused=True,
                           dtype="float16")
        with pytest.raises(ValueError, match="dtype"):
            Solver(cfg).run(port_problem())


def test_window_bytes_is_dtype_aware():
    """bf16 halves the state and parameter bytes of the window estimate;
    the int32 index bytes do not change."""
    problem = port_problem()
    lt = backends._graph_layout(problem.graph)
    pf = problem.loss.prox_param_floats(problem.data.x.shape[1],
                                        problem.num_features)
    b4 = lt.window_bytes(problem.num_features, param_floats=pf)
    b2 = lt.window_bytes(problem.num_features, param_floats=pf, itemsize=2)
    index_bytes = 2 * b2 - b4
    assert 0 < index_bytes and b4 - b2 == (b4 - index_bytes) // 2


def test_bf16_widens_the_fusable_window(monkeypatch):
    """A window cap between the bf16 and f32 estimates keeps bf16 fused
    and sends f32 to the unfused path: the gate reads the itemsize."""
    problem = port_problem()
    lt = backends._graph_layout(problem.graph)
    pf = problem.loss.prox_param_floats(problem.data.x.shape[1],
                                        problem.num_features)
    nf = problem.num_features
    cap = (lt.window_bytes(nf, param_floats=pf)
           + lt.window_bytes(nf, param_floats=pf, itemsize=2)) // 2
    monkeypatch.setenv("REPRO_FUSED_MAX_WINDOW_BYTES", str(cap))
    f32_cfg = SolverConfig(**CONF, backend="pallas", fused=True)
    assert not backends._fused_window_fits(problem, f32_cfg)
    assert backends._fused_window_fits(problem,
                                       f32_cfg.replace(dtype="bfloat16"))


@pytest.mark.parametrize("name", sorted(losses.LOSSES))
def test_kernel_safe_matches_reference(name):
    assert losses.LOSSES[name].kernel_safe
    assert losses.LOSSES[name].kernel_safe == \
        jlosses.LOSSES[name].kernel_safe


@pytest.fixture
def on_cuda(monkeypatch):
    """Problems report a CUDA device (their tensors stay on the CPU), so
    the dispatch gate decides as it does on the card.  The gate also asks
    the kernel library how many bytes a node stages; the CPU has no such
    library, so that count is stubbed to fit (these problems' nodes
    stage under 2 KB; tests/test_torch_incidence.py covers a node past
    the limit)."""
    from repro_torch.kernels import pd_step
    monkeypatch.setattr(Problem, "device",
                        property(lambda self: torch.device("cuda")))
    monkeypatch.setattr(pd_step, "staging_bytes",
                        lambda kind, n, num_samples, lanes=1: (0, 1))


@pytest.mark.parametrize("name", ["sbm_regression", "sparse_lasso",
                                  "clustered_logistic",
                                  "laplacian_smoothing"])
def test_cuda_dispatch_fuses_every_registered_loss(name, on_cuda):
    problem = port_problem(name)
    for dtype in ("float32", "bfloat16"):
        cfg = SolverConfig(**CONF, backend="pallas", dtype=dtype)
        assert backends._should_fuse(problem, cfg), (name, dtype)


def test_loss_without_prox_setup_does_not_fuse(on_cuda):
    """Fusion needs a loss the kernel can window: one without
    ``prox_setup`` runs the unfused path, as the reference's
    ``CallableLoss`` does."""
    class Opaque(losses.Loss):
        kernel_safe = True

        def prox_param_floats(self, num_samples, num_features):
            return 0

    problem = port_problem()
    problem = Problem(graph=problem.graph, data=problem.data,
                      lam=problem.lam, loss=Opaque())
    cfg = SolverConfig(**CONF, backend="pallas")
    assert not backends._should_fuse(problem, cfg)
