"""The optimality-gap certificate's pseudo-inverse (``repro_torch.engine.
step.sym_pinv``) at the port's widths, past the n = 2 of the solver tests,
and a lambda path's certificate.

``sym_pinv`` is Jacobi in tensor ops, so the certificate reads nothing on
the host; past n = 2 it sweeps ``_JACOBI_SWEEPS`` times.  It is the plain
version of the ``sym_pinv`` kernel (``kernels/sym_pinv.py``), which the
certificate runs on the card.  Held here:

  * against ``torch.linalg.pinv`` in float64 with the reference's cut
    (``10 * n * eps`` of float32) on exactly rank-deficient symmetric
    matrices (integer factors, so the rank is exact) at n = 2, 4, 16, 17,
    32 and 33 — full rank, half rank and zero;
  * ``optimality_gap`` against the reference's (``repro.engine.step``) on
    the same chain problem at n = 2, 4, 16, 17, 32 and 33, with nodes
    whose covariance is rank-deficient (fewer samples than features) and
    unlabeled nodes: relative 1e-4;
  * a lambda path's diagnostics (``solve_path``: dense, fused lanes,
    masked tol sweep): one pseudo-inverse for the path, each lane the
    bits of its own ``certificate``, near the reference's path; and
    ``solve_many``'s, one pseudo-inverse a problem.

On the card (``-m cuda``): the kernel, in the variant each width gets
(thread n <= 4, warp n <= 32, block to 169), against ``sym_pinv``
(relative 1e-4 of the float64 pinv, or twice ``sym_pinv``'s own distance
from it: the same Jacobi in another order of operations) at each
variant's edges, under ``torch.cuda.set_sync_debug_mode("error")`` and
in a CUDA-graph capture; batches of 0, 1, a ragged count and a million;
unaligned input; the widest width it takes (169) and the first it
refuses; ``optimality_gap`` launching it; and a path's certificate
launching it once.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import Problem                             # noqa: E402
from repro_torch.core.graph import chain_graph                  # noqa: E402
from repro_torch.core.losses import NodeData                    # noqa: E402
from repro_torch.engine.step import (_jacobi_plan,               # noqa: E402
                                     optimality_gap, sym_pinv)

EPS32 = float(np.finfo(np.float32).eps)


@pytest.mark.parametrize("n", [2, 3, 4, 16, 17, 32, 33])
def test_jacobi_plan_covers_every_pair_once(n):
    pairs = []
    for flat, basis in _jacobi_plan(n, torch.float32, "cpu"):
        k = basis.shape[0] // 2
        p, q = flat[:k] // n, flat[:k] % n
        assert torch.equal(flat[k:2 * k], p * n + p)
        assert torch.equal(flat[2 * k:], q * n + q)
        assert len(set(p.tolist()) | set(q.tolist())) == 2 * k  # disjoint
        # the basis puts c at (p, p), (q, q) and s, -s at (p, q), (q, p)
        c = torch.arange(k, dtype=torch.float32) + 2.0
        sn = -torch.arange(k, dtype=torch.float32) - 5.0
        rot = (torch.cat([c - 1.0, sn]) @ basis).reshape(n, n) + torch.eye(n)
        assert torch.equal(rot[p, p], c) and torch.equal(rot[q, q], c)
        assert torch.equal(rot[p, q], sn) and torch.equal(rot[q, p], -sn)
        pairs += list(zip(p.tolist(), q.tolist()))
    assert sorted(pairs) == [(p, q) for p in range(n)
                             for q in range(p + 1, n)]


def _symmetric(n: int, rank: int, seed: int, batch: int = 64):
    rng = np.random.default_rng(seed)
    f = rng.integers(-3, 4, (batch, n, max(rank, 1))).astype(np.float32)
    f *= rank > 0
    return torch.from_numpy(f @ f.transpose(0, 2, 1))


@pytest.mark.parametrize("n", [2, 4, 16, 17, 32, 33])
@pytest.mark.parametrize("rank", ["full", "half", "zero"])
def test_sym_pinv_matches_pinv(n, rank):
    r = {"full": n, "half": max(n // 2, 1), "zero": 0}[rank]
    # a full-rank draw from n + 5 factors is well conditioned
    q = (_symmetric(n, n + 5, seed=n) if rank == "full"
         else _symmetric(n, r, seed=n))
    got = sym_pinv(q)
    want = torch.linalg.pinv(q.double(), rtol=10 * n * EPS32,
                             hermitian=True)
    scale = want.abs().amax((1, 2)).clamp_min(1e-30)
    err = ((got.double() - want).abs().amax((1, 2)) / scale).max()
    assert float(err) <= 1e-4
    if rank == "zero":
        assert torch.equal(got, torch.zeros_like(got))
    # the Moore-Penrose identity Q X Q = Q
    back = torch.einsum("bij,bjk,bkl->bil", q.double(), got.double(),
                        q.double())
    qs = q.abs().amax((1, 2)).double().clamp_min(1e-30)
    assert float(((back - q).abs().amax((1, 2)) / qs).max()) <= 1e-4


def _gap_inputs(n: int, seed: int = 0, v: int = 24):
    """A chain problem's data at width n: n + 4 samples a node, nodes
    8..15 with two samples (rank-2 covariance), nodes 16..19 unlabeled;
    an iterate w and duals u away from the optimum."""
    rng = np.random.default_rng(seed)
    m = n + 4
    x = rng.standard_normal((v, m, n)).astype(np.float32)
    w_true = rng.standard_normal((v, n)).astype(np.float32)
    y = np.einsum("vmn,vn->vm", x, w_true).astype(np.float32)
    mask = np.ones((v, m), np.float32)
    mask[8:16, 2:] = 0.0
    labeled = np.ones(v, np.float32)
    labeled[16:20] = 0.0
    w = rng.standard_normal((v, n)).astype(np.float32)
    u = 0.05 * rng.standard_normal((v - 1, n)).astype(np.float32)
    return x, y, mask, labeled, w, u


@pytest.mark.parametrize("n", [2, 4, 16, 17, 32, 33])
def test_optimality_gap_matches_reference(n):
    import jax.numpy as jnp
    from repro.api import Problem as JProblem
    from repro.core.graph import chain_graph as j_chain
    from repro.core.losses import NodeData as JNodeData
    from repro.engine.step import optimality_gap as j_gap

    x, y, mask, labeled, w, u = _gap_inputs(n)
    v = x.shape[0]
    port = Problem.create(
        chain_graph(np.random.default_rng(1), v, device="cpu"),
        NodeData(x=torch.from_numpy(x), y=torch.from_numpy(y),
                 sample_mask=torch.from_numpy(mask),
                 labeled_mask=torch.from_numpy(labeled)),
        lam=5e-2, device="cpu")
    ref = JProblem.create(
        j_chain(np.random.default_rng(1), v),
        JNodeData(x=jnp.asarray(x), y=jnp.asarray(y),
                  sample_mask=jnp.asarray(mask),
                  labeled_mask=jnp.asarray(labeled)),
        lam=5e-2)
    got = float(optimality_gap(port, torch.from_numpy(w),
                               torch.from_numpy(u)))
    want = float(j_gap(ref, jnp.asarray(w), jnp.asarray(u)))
    assert np.isfinite(got)
    assert abs(got - want) <= 1e-4 * abs(want)


def _chain_problems(n: int = 2):
    """``_gap_inputs``'s chain problem at width n in both packages."""
    import jax.numpy as jnp
    from repro.api import Problem as JProblem
    from repro.core.graph import chain_graph as j_chain
    from repro.core.losses import NodeData as JNodeData

    x, y, mask, labeled, _, _ = _gap_inputs(n)
    v = x.shape[0]
    port = Problem.create(
        chain_graph(np.random.default_rng(1), v, device="cpu"),
        NodeData(x=torch.from_numpy(x), y=torch.from_numpy(y),
                 sample_mask=torch.from_numpy(mask),
                 labeled_mask=torch.from_numpy(labeled)),
        lam=5e-2, device="cpu")
    ref = JProblem.create(
        j_chain(np.random.default_rng(1), v),
        JNodeData(x=jnp.asarray(x), y=jnp.asarray(y),
                  sample_mask=jnp.asarray(mask),
                  labeled_mask=jnp.asarray(labeled)),
        lam=5e-2)
    return port, ref


PATH_LAMS = (1e-2, 3e-2, 1e-1)
PATH_CONF = dict(rho=1.9, warm_iters=20, final_iters=20, metric_every=10)
PATH_ROUTES = {"dense": dict(backend="dense"),
               "pallas_fused": dict(backend="pallas", fused=True),
               "tol": dict(backend="dense", tol=1e-3)}
_reference_path: dict = {}


@pytest.mark.parametrize("route", sorted(PATH_ROUTES))
def test_path_certificate_one_pinv_a_path(route, monkeypatch):
    """A lambda path's diagnostics on the chain problem of
    ``_gap_inputs`` over three lambdas (the fixed-budget dense path, the
    fused lanes, the masked tol sweep): one ``certificate_pinv`` for the
    path (its lanes share the data, as the reference's vmap over (lam,
    w, u) shares its pinv), each lane's diagnostics the bits of its own
    ``certificate``, and on the fixed-budget routes each near the
    reference's dense ``solve_path``: ``dual_infeasibility`` within 1e-6 (as
    ``test_torch_path.py``), the stationarity residual within 1e-5 (a
    max of sums of terms of order one) and the gap within this file's
    relative 1e-4, taken of the terms it sums: P(w) and each labeled
    node's y^T y / m, of which its loss value is a difference (near the
    optimum the float32 gap is their rounding, in both packages)."""
    import jax.numpy as jnp
    from repro.api import SolverConfig as JConfig
    from repro.api import solve_path as j_solve_path
    from repro_torch.api import SolverConfig, solve_path
    from repro_torch.engine import step

    port, ref = _chain_problems()
    calls = []
    real = step.certificate_pinv

    def counted(a):
        calls.append(tuple(a.shape))
        return real(a)

    monkeypatch.setattr(step, "certificate_pinv", counted)
    conf = dict(PATH_CONF, **PATH_ROUTES[route])
    got = solve_path(port, PATH_LAMS, SolverConfig(**conf))
    assert calls == [(port.num_nodes, 2, 2)]
    for k, lam in enumerate(PATH_LAMS):
        one = step.certificate(port.with_lam(lam), got.w[k], got.u[k])
        assert set(one) <= set(got.diagnostics)
        for name, v in one.items():
            assert torch.equal(got.diagnostics[name][k], v), (name, lam)
    assert len(calls) == 1 + len(PATH_LAMS)

    if route == "tol":
        # its lanes' certificates are held above; the reference's masked
        # sweep would add its compile (~3 s) to this file
        return
    if not _reference_path:                # the fused route's is dense's
        _reference_path.update(j_solve_path(
            ref, jnp.asarray(PATH_LAMS, jnp.float32),
            JConfig(**PATH_CONF, backend="dense")).diagnostics)
    want = _reference_path
    diag = {k: np.asarray(v) for k, v in got.diagnostics.items()}
    np.testing.assert_allclose(diag["dual_infeasibility"],
                               np.asarray(want["dual_infeasibility"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(diag["stationarity_residual_labeled"],
                               np.asarray(
                                   want["stationarity_residual_labeled"]),
                               rtol=0, atol=1e-5)
    d = port.data
    yty = float(torch.sum(torch.sum(d.y ** 2 * d.sample_mask, dim=1)
                          / d.counts() * d.labeled_mask))
    for k, lam in enumerate(PATH_LAMS):
        primal = float(port.with_lam(lam).objective(got.w[k]))
        gap, ref_gap = diag["optimality_gap"][k], want["optimality_gap"][k]
        assert abs(gap - float(ref_gap)) <= 1e-4 * (abs(primal) + yty), lam


def test_solve_many_certificate_one_pinv_a_problem(monkeypatch):
    """``solve_many``'s problems have their own data: one
    ``certificate_pinv`` each, and each problem's diagnostics the bits
    of its own ``certificate``."""
    from repro_torch.api import SolverConfig, solve_many
    from repro_torch.engine import step

    port, _ = _chain_problems()
    d = port.data
    other = dataclasses.replace(port, data=NodeData(
        x=d.x * 0.5, y=d.y, sample_mask=d.sample_mask,
        labeled_mask=d.labeled_mask))
    calls = []
    real = step.certificate_pinv
    monkeypatch.setattr(step, "certificate_pinv",
                        lambda a: calls.append(1) or real(a))
    got = solve_many([port, other], SolverConfig(rho=1.9, num_iters=40,
                                                 metric_every=10))
    assert len(calls) == 2
    for res, problem in zip(got, (port, other)):
        one = step.certificate(problem, res.w, res.u)
        for name, v in one.items():
            assert torch.equal(res.diagnostics[name], v), name


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


#: each variant's edges: thread n <= 4, warp n <= 32, block to 169
CARD_WIDTHS = [1, 2, 3, 4, 5, 16, 17, 31, 32, 33, 64, 169]
VARIANT_OF = {1: "thread", 2: "thread", 3: "thread", 4: "thread",
              5: "warp", 16: "warp", 17: "warp", 31: "warp", 32: "warp",
              33: "block", 64: "block", 169: "block"}


def _exact_distance(q):
    """``dist(t)``: t's largest distance from q's float64 pinv (the
    reference's cut), relative to each matrix's scale; the pinv on the
    host (cuSOLVER's batched eigensolver refuses a batch of a million)."""
    n = q.shape[-1]
    exact = torch.linalg.pinv(q.double().cpu(), rtol=10 * n * EPS32,
                              hermitian=True)
    scale = exact.abs().amax((1, 2)).clamp_min(1e-30)

    def dist(t):
        return float(((t.double().cpu() - exact).abs().amax((1, 2))
                      / scale).max())
    return dist


@pytest.mark.cuda
@pytest.mark.parametrize("n", CARD_WIDTHS)
@pytest.mark.parametrize("rank", ["full", "half", "zero"])
def test_cuda_sym_pinv_kernel_matches_plain_version(n, rank):
    """The kernel, in the variant its width gets, against ``sym_pinv``
    on the card (relative 1e-4 at each matrix's scale, or twice
    ``sym_pinv``'s own distance from the float64 pinv where that is
    larger: at n = 64 float32 resolves these integer matrices'
    pseudo-inverses to ~1e-4 by itself), with no host read (sync debug
    mode "error") and captured into a CUDA graph whose replay gives the
    same bits."""
    _need_card()
    from repro_torch.engine.step import jacobi_sweeps
    from repro_torch.kernels import sym_pinv as kernel

    assert kernel.variant(n) == VARIANT_OF[n]
    # full rank: n + 5 factors, well conditioned to n = 64; at n = 169
    # such a draw has condition ~1e4 and float32 resolves its pinv to
    # ~1e-4 in any order of operations (the kernel 1.46e-4 from the
    # float64 pinv, sym_pinv 6.5e-5), so there it takes 2 n factors
    full = n + 5 if n <= 64 else 2 * n
    r = {"full": full, "half": max(n // 2, 1), "zero": 0}[rank]
    q = _symmetric(n, r, seed=n, batch=64 if n <= 64 else 8).cuda()
    want = sym_pinv(q)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = kernel.sym_pinv(q, sweeps=jacobi_sweeps(n))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    dist = _exact_distance(q)
    assert dist(got) <= max(1e-4, 2.0 * dist(want))
    if rank == "zero":
        assert torch.equal(got, torch.zeros_like(got))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = kernel.sym_pinv(q, sweeps=jacobi_sweeps(n))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, got)


@pytest.mark.cuda
@pytest.mark.parametrize("n,batch", [(2, 0), (2, 1), (2, 257),
                                     (2, 1_000_000), (4, 257), (5, 0),
                                     (5, 1), (5, 7), (16, 5), (33, 0),
                                     (33, 1), (33, 3)])
def test_cuda_sym_pinv_batches(n, batch):
    """Batches of 0 (no launch), 1, a count that is not a whole number
    of the variant's matrices a block (256 a block for the thread
    variant, 4 for the warp's) and a million at n = 2: covariances of n +
    4 draws from a seeded generator on the card, against ``sym_pinv`` as
    in ``test_cuda_sym_pinv_kernel_matches_plain_version``."""
    _need_card()
    from repro_torch.engine.step import jacobi_sweeps
    from repro_torch.kernels import sym_pinv as kernel

    gen = torch.Generator(device="cuda").manual_seed(batch + n)
    x = torch.randn((batch, n + 4, n), device="cuda", generator=gen)
    q = (torch.einsum("vmn,vmk->vnk", x, x) / (n + 4)).contiguous()
    before = kernel.sym_pinv.launches
    got = kernel.sym_pinv(q, sweeps=jacobi_sweeps(n))
    assert got.shape == q.shape
    assert kernel.sym_pinv.launches == before + (batch > 0)
    if batch:
        dist = _exact_distance(q)
        assert dist(got) <= max(1e-4, 2.0 * dist(sym_pinv(q)))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_cuda_sym_pinv_thread_variant_unaligned(n):
    """A contiguous batch that does not start on a 16-byte word (a view a
    float into a buffer) takes the thread variant's float-at-a-time
    loads and stores, with the bits of the 16-byte ones."""
    _need_card()
    from repro_torch.engine.step import jacobi_sweeps
    from repro_torch.kernels import sym_pinv as kernel

    q = _symmetric(n, n + 5, seed=n, batch=37).cuda()
    buf = torch.empty(q.numel() + 1, device="cuda")
    shifted = buf[1:].view(q.shape)
    shifted.copy_(q)
    assert shifted.data_ptr() % 16 == 4 and shifted.is_contiguous()
    got = kernel.sym_pinv(shifted, sweeps=jacobi_sweeps(n))
    assert torch.equal(got, kernel.sym_pinv(q, sweeps=jacobi_sweeps(n)))


@pytest.mark.cuda
def test_cuda_sym_pinv_widths_and_certificate():
    """The block variant keeps a matrix and its rotations (2 n^2 floats)
    in one block's shared memory: the kernel takes n = 169 and refuses
    170, naming the limit; ``variant`` names each width's variant;
    ``optimality_gap`` on the card launches the kernel once."""
    _need_card()
    from repro_torch.kernels import sym_pinv as kernel

    assert kernel.takes(169) and not kernel.takes(170)
    assert all(kernel.variant(n) == v for n, v in VARIANT_OF.items())
    with pytest.raises(NotImplementedError, match="shared memory"):
        kernel.sym_pinv(torch.eye(170, device="cuda")[None], sweeps=1)
    x, y, mask, labeled, w, u = _gap_inputs(16)
    v = x.shape[0]
    port = Problem.create(
        chain_graph(np.random.default_rng(1), v, device="cuda"),
        NodeData(*(torch.from_numpy(a).cuda() for a in (x, y, mask,
                                                        labeled))),
        lam=5e-2, device="cuda")
    before = kernel.sym_pinv.launches
    got = optimality_gap(port, torch.from_numpy(w).cuda(),
                         torch.from_numpy(u).cuda())
    assert kernel.sym_pinv.launches == before + 1
    cpu = Problem.create(
        chain_graph(np.random.default_rng(1), v, device="cpu"),
        NodeData(*(torch.from_numpy(a) for a in (x, y, mask, labeled))),
        lam=5e-2, device="cpu")
    want = optimality_gap(cpu, torch.from_numpy(w), torch.from_numpy(u))
    assert abs(float(got) - float(want)) <= 1e-4 * abs(float(want))


@pytest.mark.cuda
@pytest.mark.parametrize("route", sorted(PATH_ROUTES))
def test_cuda_path_certificate_launches_once(route):
    """On the card a lambda path's certificate launches ``sym_pinv`` once
    (the fixed-budget dense path, the fused lanes, the masked tol
    sweep), and each lane's diagnostics are the bits of its own
    ``certificate`` (one launch each)."""
    _need_card()
    from repro_torch.api import SolverConfig, solve_path
    from repro_torch.engine.step import certificate
    from repro_torch.kernels import sym_pinv as kernel

    x, y, mask, labeled, _, _ = _gap_inputs(2)
    port = Problem.create(
        chain_graph(np.random.default_rng(1), x.shape[0], device="cuda"),
        NodeData(*(torch.from_numpy(a).cuda() for a in (x, y, mask,
                                                        labeled))),
        lam=5e-2, device="cuda")
    before = kernel.sym_pinv.launches
    got = solve_path(port, PATH_LAMS,
                     SolverConfig(**PATH_CONF, **PATH_ROUTES[route]))
    torch.cuda.synchronize()
    assert kernel.sym_pinv.launches == before + 1
    for k, lam in enumerate(PATH_LAMS):
        one = certificate(port.with_lam(lam), got.w[k], got.u[k])
        for name, v in one.items():
            assert torch.equal(got.diagnostics[name][k], v), (name, lam)
    assert kernel.sym_pinv.launches == before + 1 + len(PATH_LAMS)
