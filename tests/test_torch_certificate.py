"""The optimality-gap certificate's pseudo-inverse (``repro_torch.engine.
step.sym_pinv``) at the port's widths, past the n = 2 of the solver tests.

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
    unlabeled nodes: relative 1e-4.

On the card (``-m cuda``): the kernel against ``sym_pinv`` (relative
1e-4 of the float64 pinv, or twice ``sym_pinv``'s own distance from it:
the same Jacobi in another order of operations) at n = 2-64, under
``torch.cuda.set_sync_debug_mode("error")`` and in a CUDA-graph capture;
the widest width it takes (169) and the first it refuses; and
``optimality_gap`` launching it.
"""
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


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 16, 17, 32, 33, 64])
@pytest.mark.parametrize("rank", ["full", "half", "zero"])
def test_cuda_sym_pinv_kernel_matches_plain_version(n, rank):
    """The kernel against ``sym_pinv`` on the card (relative 1e-4 at each
    matrix's scale, or twice ``sym_pinv``'s own distance from the float64
    pinv where that is larger: at n = 64 float32 resolves these integer
    matrices' pseudo-inverses to ~1e-4 by itself), with no host read
    (sync debug mode "error") and captured into a CUDA graph whose replay
    gives the same bits."""
    _need_card()
    from repro_torch.engine.step import jacobi_sweeps
    from repro_torch.kernels import sym_pinv as kernel

    r = {"full": n + 5, "half": max(n // 2, 1), "zero": 0}[rank]
    q = _symmetric(n, r, seed=n).cuda()
    want = sym_pinv(q)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = kernel.sym_pinv(q, sweeps=jacobi_sweeps(n))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    exact = torch.linalg.pinv(q.double(), rtol=10 * n * EPS32,
                              hermitian=True)
    scale = exact.abs().amax((1, 2)).clamp_min(1e-30)

    def dist(t):
        return float(((t.double() - exact).abs().amax((1, 2)) / scale).max())
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
def test_cuda_sym_pinv_widths_and_certificate():
    """The kernel keeps a matrix and its rotations (2 n^2 floats) in one
    block's shared memory: it takes n = 169 and refuses 170, naming the
    limit; ``optimality_gap`` on the card launches it once."""
    _need_card()
    from repro_torch.kernels import sym_pinv as kernel

    assert kernel.takes(169) and not kernel.takes(170)
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
