"""The port's kernels: port against reference, and kernel against its
plain version.

On the CPU the port's ``fused_pd_step_ref`` is held against the
reference's Pallas kernel in interpret mode and against the reference's
jnp ``fused_pd_step_ref``, on the storage shapes of
``tests/test_kernels.py`` (rtol = atol = 1e-6, the reference suite's own:
the two frameworks sum the D^T u gather in another order).  The plain
``tv_prox`` and ``batched_affine`` (and ``ops`` on CPU tensors) are held
against the reference's interpret-mode kernels at that suite's
tolerances (1e-6 and 1e-5).  The CUDA kernels themselves run only on the
card (``-m cuda``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api.losses import SquaredLoss              # noqa: E402
from repro_torch.api.regularizers import SquaredTV, TotalVariation  # noqa
from repro_torch.core.graph import plan_edge_blocks, sbm_graph  # noqa: E402
from repro_torch.kernels import ops, ref                    # noqa: E402
from repro_torch.kernels.pd_step import fused_pd_step       # noqa: E402
from repro_torch.kernels.ridge_prox import batched_affine   # noqa: E402
from repro_torch.kernels.tv_prox import tv_prox             # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)
REGS = {"tv": TotalVariation(), "tv2": SquaredTV()}


def _reference():
    """The reference package's pieces (JAX on the CPU), imported where a
    test compares against them: the card's machine runs the CUDA test
    of this file without JAX."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.api import losses, regularizers
    from repro.kernels import pd_step, ref as jref
    return dict(jnp=jnp, loss=losses.SquaredLoss(), ref=jref,
                kernel=pd_step.fused_pd_step,
                regs={"tv": regularizers.TotalVariation(),
                      "tv2": regularizers.SquaredTV()})


def _step_arrays(v, n, bv, seed):
    """numpy storage arrays of one fused step, squared-loss params in
    sorted-key order ("b", "p").  The layout is planned by the port's
    planner, bit-equal to the reference's (``test_torch_graph.py``)."""
    rng = np.random.default_rng(seed)
    g, _ = sbm_graph(rng, (v // 2, v - v // 2), p_in=0.3, p_out=0.03,
                     device="cpu")
    lt = plan_edge_blocks(g, block_nodes=bv)
    ext = (lt.kn - 1) * lt.block_nodes
    f32 = np.float32

    def pad(a):
        return np.pad(a, ((0, ext),) + ((0, 0),) * (a.ndim - 1))

    inc_s = lt.inc_signs.numpy()
    deg = (inc_s != 0).sum(1).astype(f32)
    tau = np.where(deg > 0, 1.0 / np.maximum(deg, 1.0), 1.0).astype(f32)
    klo_rows, khi_rows = lt.klo * lt.block_edges, lt.khi * lt.block_edges
    arrays = (
        pad(rng.standard_normal((lt.nodes_pad, n)).astype(f32)),
        np.pad((0.1 * rng.standard_normal((lt.edges_pad, n))).astype(f32),
               ((klo_rows, khi_rows), (0, 0))),
        pad(lt.inc_edges.numpy()), pad(inc_s),
        (pad((0.1 * rng.standard_normal((lt.nodes_pad, n))).astype(f32)),
         pad((0.1 * rng.standard_normal((lt.nodes_pad, n, n))
              + np.eye(n)).astype(f32))),
        pad(tau[:, None]), lt.src.numpy()[:, None],
        lt.dst.numpy()[:, None], np.full((lt.edges_pad, 1), 0.5, f32),
        (1e-1 * lt.weights.numpy())[:, None].astype(f32),
    )
    extents = dict(pkeys=("b", "p"), block_nodes=lt.block_nodes,
                   block_edges=lt.block_edges, kn=lt.kn, klo=lt.klo,
                   khi=lt.khi)
    return arrays, extents


def _as(arrays, to):
    return tuple(tuple(to(b) for b in a) if isinstance(a, tuple) else to(a)
                 for a in arrays)


def _to_torch(a, device="cpu"):
    return torch.from_numpy(np.array(a)).to(device)


SHAPES = [(61, 2, 16), (103, 3, 32), (40, 4, 64)]


@pytest.mark.parametrize("v,n,bv", SHAPES)
@pytest.mark.parametrize("rho", [1.0, 1.9])
@pytest.mark.parametrize("reg", ["tv", "tv2"])
@pytest.mark.parametrize("compute_residual", [False, True])
def test_fused_pd_step_ref_matches_reference(v, n, bv, rho, reg,
                                             compute_residual):
    arrays, ext = _step_arrays(v, n, bv, seed=v)
    j = _reference()
    kw = dict(ext, rho=rho, compute_residual=compute_residual)
    out = ref.fused_pd_step_ref(*_as(arrays, _to_torch), loss=SquaredLoss(),
                                reg=REGS[reg], **kw)
    j_args = _as(arrays, j["jnp"].asarray)
    jkw = dict(kw, loss=j["loss"], reg=j["regs"][reg])
    want_ref = j["ref"].fused_pd_step_ref(*j_args, **jkw)
    want_kernel = j["kernel"](*j_args, **jkw, interpret=True)
    assert len(out) == len(want_ref) == 2 + compute_residual
    for want in (want_ref, want_kernel):
        for o, w in zip(out, want):
            np.testing.assert_allclose(o.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("reg", ["tv", "tv2"])
def test_multi_iteration_equals_repeated_single(reg):
    """Single-block iters=5 == five single steps, and == the reference's
    iters=5 (with its in-call running-max residual)."""
    arrays, ext = _step_arrays(48, 2, None, seed=4)          # one block
    assert ext["kn"] == 1 and ext["klo"] == 0 and ext["khi"] == 0
    j = _reference()
    kw = dict(ext, rho=1.9, loss=SquaredLoss(), reg=REGS[reg])
    t_args = _as(arrays, _to_torch)
    w_m, u_m, res_m = ref.fused_pd_step_ref(*t_args, **kw, iters=5,
                                            compute_residual=True)
    w, u, res = t_args[0], t_args[1], torch.zeros(())
    for _ in range(5):
        w, u, r = ref.fused_pd_step_ref(w, u, *t_args[2:], **kw,
                                        compute_residual=True)
        res = torch.maximum(res, r)
    np.testing.assert_allclose(w_m.numpy(), w.numpy(), **TOL)
    np.testing.assert_allclose(u_m.numpy(), u.numpy(), **TOL)
    np.testing.assert_allclose(float(res_m), float(res), **TOL)
    j_out = j["ref"].fused_pd_step_ref(
        *_as(arrays, j["jnp"].asarray), loss=j["loss"], reg=j["regs"][reg],
        rho=1.9, **ext, iters=5, compute_residual=True)
    for o, w_ in zip((w_m, u_m, res_m), j_out):
        np.testing.assert_allclose(o.numpy(), np.asarray(w_), **TOL)


def test_ops_routes_cpu_tensors_to_plain_version():
    """``ops.pd_step`` runs the plain version on CPU tensors and never
    counts a kernel launch; the kernel wrapper refuses them."""
    arrays, ext = _step_arrays(61, 2, 16, seed=1)
    t_args = _as(arrays, _to_torch)
    kw = dict(ext, loss=SquaredLoss(), reg=TotalVariation(), rho=1.9)
    before = fused_pd_step.launches
    got = ops.pd_step(*t_args, **kw)
    want = ref.fused_pd_step_ref(*t_args, **kw)
    for o, w in zip(got, want):
        assert torch.equal(o, w)
    assert fused_pd_step.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        fused_pd_step(*t_args, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("v,n,bv", SHAPES + [(48, 2, None)])
@pytest.mark.parametrize("rho", [1.0, 1.9])
@pytest.mark.parametrize("reg", ["tv", "tv2"])
def test_cuda_kernel_matches_plain_version(v, n, bv, rho, reg):
    """The CUDA kernel against its plain version on the card (1e-5: the
    kernel sums the gather in slot order with fused multiply-adds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    arrays, ext = _step_arrays(v, n, bv, seed=v)
    args = _as(arrays, lambda a: _to_torch(a, "cuda"))
    kw = dict(ext, loss=SquaredLoss(), reg=REGS[reg], rho=rho,
              compute_residual=True)
    iters = 5 if bv is None else 1
    got = fused_pd_step(*args, **kw, iters=iters)
    want = ref.fused_pd_step_ref(*args, **kw, iters=iters)
    torch.cuda.synchronize()
    for o, w in zip(got, want):
        np.testing.assert_allclose(o.cpu().numpy(), w.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# tv_prox and batched_affine (the unfused pallas path's kernels)
# ---------------------------------------------------------------------------
TV_SHAPES = [(7, 2), (512, 2), (1000, 16), (33, 5), (1, 1), (65, 3)]
AFFINE_SHAPES = [(300, 2), (64, 8), (1000, 32), (13, 3), (1, 1), (65, 3)]


def _tv_arrays(e, n, seed=0):
    """u drawn from twice the box scale, so about half the entries clip."""
    rng = np.random.default_rng(seed)
    u = (2.0 * rng.standard_normal((e, n))).astype(np.float32)
    bound = np.abs(rng.standard_normal(e)).astype(np.float32)
    return u, bound


def _affine_arrays(v, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((v, n, n)).astype(np.float32),
            rng.standard_normal((v, n)).astype(np.float32))


@pytest.mark.parametrize("e,n", TV_SHAPES)
def test_tv_prox_matches_reference_kernel(e, n):
    from repro.kernels.tv_prox import tv_prox as j_tv_prox
    u, bound = _tv_arrays(e, n, seed=e)
    jnp = _reference()["jnp"]
    want = np.asarray(j_tv_prox(jnp.asarray(u), jnp.asarray(bound),
                                interpret=True, block_e=64))
    tu, tb = torch.from_numpy(u), torch.from_numpy(bound)
    for got in (ref.tv_prox_ref(tu, tb), ops.tv_prox(tu, tb)):
        assert got.shape == (e, n) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("v,n", AFFINE_SHAPES)
def test_batched_affine_matches_reference_kernel(v, n):
    from repro.kernels.ridge_prox import batched_affine as j_affine
    p, x = _affine_arrays(v, n, seed=v)
    jnp = _reference()["jnp"]
    want = np.asarray(j_affine(jnp.asarray(p), jnp.asarray(x),
                               interpret=True, block_v=64))
    tp, tx = torch.from_numpy(p), torch.from_numpy(x)
    for got in (ref.batched_affine_ref(tp, tx), ops.batched_affine(tp, tx)):
        assert got.shape == (v, n) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_unfused_kernel_wrappers_refuse_cpu_tensors():
    """``ops`` routes CPU tensors to the plain versions and counts no
    launch; the kernel wrappers themselves refuse CPU tensors."""
    u, bound = (torch.from_numpy(a) for a in _tv_arrays(9, 2))
    p, x = (torch.from_numpy(a) for a in _affine_arrays(9, 2))
    before = (tv_prox.launches, batched_affine.launches)
    assert torch.equal(ops.tv_prox(u, bound), ref.tv_prox_ref(u, bound))
    assert torch.equal(ops.batched_affine(p, x),
                       ref.batched_affine_ref(p, x))
    assert (tv_prox.launches, batched_affine.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        tv_prox(u, bound)
    with pytest.raises(ValueError, match="CUDA"):
        batched_affine(p, x)


@pytest.mark.cuda
@pytest.mark.parametrize("e,n", TV_SHAPES + [(0, 2)])
def test_cuda_tv_prox_matches_plain_version(e, n):
    """Bit for bit: the kernel's fminf(fmaxf(u, -b), b) is torch.clamp."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    u, bound = (torch.from_numpy(a).cuda() for a in _tv_arrays(e, n, seed=e))
    before = tv_prox.launches
    got = tv_prox(u, bound)
    want = ref.tv_prox_ref(u, bound)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert tv_prox.launches == before + (e > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("v,n", AFFINE_SHAPES + [(0, 2)])
def test_cuda_batched_affine_matches_plain_version(v, n):
    """Within 1e-5: the kernel sums k ascending with fused multiply-adds,
    the plain einsum in its own order."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    p, x = (torch.from_numpy(a).cuda() for a in _affine_arrays(v, n, seed=v))
    before = batched_affine.launches
    got = batched_affine(p, x)
    want = ref.batched_affine_ref(p, x)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    assert batched_affine.launches == before + (v > 0)
