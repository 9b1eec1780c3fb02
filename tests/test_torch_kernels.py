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

from repro_torch.api.losses import (LassoLoss, LogisticLoss,  # noqa: E402
                                    SquaredLoss)
from repro_torch.api.regularizers import SquaredTV, TotalVariation  # noqa
from repro_torch.core.graph import (compact_incidence,          # noqa: E402
                                    plan_edge_blocks, sbm_graph)
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
                losses={"squared": losses.SquaredLoss(),
                        "lasso": losses.LassoLoss(**LASSO_KW),
                        "logistic": losses.LogisticLoss()},
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


PKEYS = {"squared": ("b", "p"),
         "lasso": ("labeled", "m", "q", "step", "tau", "xty"),
         "logistic": ("labeled", "m", "mask", "tau", "x", "y")}
LASSO_KW = dict(alpha=0.02, num_inner=30)       # the zoo's sparse_lasso


def _loss_arrays(loss, v, n, bv, seed):
    """``_step_arrays`` with the prox parameters of ``loss`` in pkeys
    order, from local data drawn like the zoo's: lasso 3 samples per
    node (the m_i < n regime), logistic 8 with Bernoulli labels and a
    masked last sample on every third node; half the nodes labeled.
    The halo suffix rows are zero, as ``pad_node_store`` leaves them."""
    arrays, ext = _step_arrays(v, n, bv, seed)
    if loss == "squared":
        return arrays, ext
    rng = np.random.default_rng(seed + 1)
    f32 = np.float32
    rows = arrays[0].shape[0]
    owned = rows - (ext["kn"] - 1) * ext["block_nodes"]
    tau = arrays[5][:owned, 0].astype(np.float64)
    ms = 3 if loss == "lasso" else 8
    x = rng.standard_normal((owned, ms, n))
    mask = np.ones((owned, ms))
    if loss == "logistic":
        mask[::3, -1] = 0.0
    m = mask.sum(1)
    labeled = (rng.random(owned) < 0.5).astype(np.float64)
    if loss == "lasso":
        y = np.einsum("vmn,vn->vm", x, rng.standard_normal((owned, n)))
        q = np.einsum("vmn,vmk->vnk", x, x)
        xty = np.einsum("vmn,vm->vn", x, y)
        lips = 2.0 * np.linalg.eigvalsh(q)[:, -1] / m + 1.0 / tau
        leaves = (labeled[:, None], m[:, None], q, (1.0 / lips)[:, None],
                  tau[:, None], xty)
    else:
        y = (rng.random((owned, ms)) < 0.5) * mask
        leaves = (labeled[:, None], m[:, None], mask, tau[:, None], x, y)
    ext_rows = rows - owned
    params = tuple(np.pad(a.astype(f32), ((0, ext_rows),)
                          + ((0, 0),) * (a.ndim - 1)) for a in leaves)
    arrays = arrays[:4] + (params,) + arrays[5:]
    return arrays, dict(ext, pkeys=PKEYS[loss])


def _incidence(arrays, ext, device="cpu"):
    """The compact incidence of the step's layout nodes (the first
    nb*BV rows of its padded tables), as the CUDA kernel takes it."""
    nodes = arrays[8].shape[0] // ext["block_edges"] * ext["block_nodes"]
    return tuple(_to_torch(a, device) for a in compact_incidence(
        arrays[2][:nodes], arrays[3][:nodes]))


def _port_loss(loss):
    return {"squared": SquaredLoss(), "lasso": LassoLoss(**LASSO_KW),
            "logistic": LogisticLoss()}[loss]


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


@pytest.mark.parametrize("loss", ["lasso", "logistic"])
@pytest.mark.parametrize("v,n,bv", SHAPES + [(50, 16, 32)])
@pytest.mark.parametrize("rho,reg", [(1.0, "tv"), (1.9, "tv2")])
def test_loss_variants_match_reference(loss, v, n, bv, rho, reg):
    """Lasso and logistic steps of the port's plain version against the
    reference's jnp ``fused_pd_step_ref`` (float32, 1e-5: the ISTA and
    Newton inner loops repeat the gather-order difference ``TOL`` allows
    for num_inner times), with the residual; (50, 16, 32) reaches the
    kernel's widest tile."""
    arrays, ext = _loss_arrays(loss, v, n, bv, seed=v)
    j = _reference()
    kw = dict(ext, rho=rho, compute_residual=True)
    out = ref.fused_pd_step_ref(*_as(arrays, _to_torch), loss=_port_loss(loss),
                                reg=REGS[reg], **kw)
    want = j["ref"].fused_pd_step_ref(
        *_as(arrays, j["jnp"].asarray), loss=j["losses"][loss],
        reg=j["regs"][reg], **kw)
    for o, w in zip(out, want):
        np.testing.assert_allclose(o.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("loss", ["lasso", "logistic"])
@pytest.mark.parametrize("reg", ["tv", "tv2"])
def test_loss_variants_multi_iteration_match_reference(loss, reg):
    """iters=5 on a single block, with the running-max residual."""
    arrays, ext = _loss_arrays(loss, 48, 2, None, seed=4)
    assert ext["kn"] == 1
    j = _reference()
    kw = dict(ext, rho=1.9, iters=5, compute_residual=True)
    out = ref.fused_pd_step_ref(*_as(arrays, _to_torch), loss=_port_loss(loss),
                                reg=REGS[reg], **kw)
    want = j["ref"].fused_pd_step_ref(
        *_as(arrays, j["jnp"].asarray), loss=j["losses"][loss],
        reg=j["regs"][reg], **kw)
    for o, w in zip(out, want):
        np.testing.assert_allclose(o.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def bf16_ulp(scale: float) -> float:
    """One bfloat16 ulp (8 significant bits) at magnitude ``scale``."""
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


def _bf16(arrays, to, cast):
    """The step's arrays through ``to``, with the storage ones (w, u and
    the prox parameters) rounded by ``cast`` to bfloat16; tau, sigma, la
    and the incidence stay f32 and int."""
    return tuple(tuple(cast(to(b)) for b in a) if isinstance(a, tuple)
                 else cast(to(a)) if i in (0, 1) else to(a)
                 for i, a in enumerate(arrays))


@pytest.mark.parametrize("loss", ["squared", "lasso", "logistic"])
@pytest.mark.parametrize("v,n,bv,rho,reg,iters", [
    (61, 2, 16, 1.9, "tv", 1), (40, 4, 64, 1.0, "tv2", 1),
    (48, 2, None, 1.9, "tv", 5)])
def test_bf16_step_matches_reference(loss, v, n, bv, rho, reg, iters):
    """bf16 storage, f32 arithmetic: the port's plain step against the
    reference's on the same bf16 inputs.  Both compute in f32 and round
    the outputs to nearest even once, so they differ where an f32
    difference straddles a rounding boundary: by at most one bf16 ulp at
    the state's scale (measured: at most one ulp, on a few elements).
    The residual compares rounded outputs with the inputs (iters == 1),
    so such a flip moves it by at most that ulp over min(tau, sigma)."""
    arrays, ext = _loss_arrays(loss, v, n, bv, seed=v)
    j = _reference()
    jnp = j["jnp"]
    kw = dict(ext, rho=rho, iters=iters, compute_residual=True)
    t_args = _bf16(arrays, _to_torch, lambda t: t.to(torch.bfloat16))
    j_args = _bf16(arrays, jnp.asarray, lambda a: a.astype(jnp.bfloat16))
    w, u, r = ref.fused_pd_step_ref(*t_args, loss=_port_loss(loss),
                                    reg=REGS[reg], **kw)
    jw, ju, jr = j["ref"].fused_pd_step_ref(
        *j_args, loss=j["losses"][loss], reg=j["regs"][reg], **kw)
    assert w.dtype == u.dtype == torch.bfloat16 and r.dtype == torch.float32
    got = (w.float().numpy(), u.float().numpy())
    want = (np.asarray(jw, np.float32), np.asarray(ju, np.float32))
    for g, wt in zip(got, want):
        scale = float(np.abs(wt).max())
        assert np.abs(g - wt).max() <= bf16_ulp(scale)
    steps = min(float(arrays[5][arrays[5] > 0].min()),
                float(arrays[8].min()))
    ulp = bf16_ulp(max(float(np.abs(x).max()) for x in want))
    np.testing.assert_allclose(float(r), float(jr), rtol=1e-5,
                               atol=ulp / steps)


@pytest.mark.parametrize("e,n", [(7, 2), (512, 2), (1000, 16), (33, 5)])
def test_tv_prox_bf16_matches_reference(e, n):
    """bf16 u against the reference's bf16 kernel (interpret mode), on
    its shapes: both round the bound to bf16 and clip, so the results
    are equal bit for bit."""
    from repro.kernels.tv_prox import tv_prox as j_tv_prox
    u, bound = _tv_arrays(e, n, seed=e)
    jnp = _reference()["jnp"]
    want = np.asarray(j_tv_prox(jnp.asarray(u).astype(jnp.bfloat16),
                                jnp.asarray(bound), interpret=True,
                                block_e=64).astype(jnp.float32))
    tu = torch.from_numpy(u).to(torch.bfloat16)
    tb = torch.from_numpy(bound)
    for got in (ref.tv_prox_ref(tu, tb), ops.tv_prox(tu, tb)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_stop_word_and_in_place_out():
    """``out`` may be the owned rows of the state (the solver updates in
    place) and gives the fresh result; a clear stop word leaves ``out``
    as it is and returns a 0 residual."""
    arrays, ext = _loss_arrays("logistic", 61, 2, 16, seed=3)
    kw = dict(ext, loss=_port_loss("logistic"), reg=REGS["tv"], rho=1.9,
              compute_residual=True)
    t_args = _as(arrays, _to_torch)
    w_f, u_f, r_f = ref.fused_pd_step_ref(*t_args, **kw)
    nodes, edges = w_f.shape[0], u_f.shape[0]
    lo = ext["klo"] * ext["block_edges"]
    for flag in (True, False):
        w_s, u_s = t_args[0].clone(), t_args[1].clone()
        out = (w_s[:nodes], u_s[lo:lo + edges])
        w_o, u_o, r_o = ref.fused_pd_step_ref(
            w_s, u_s, *t_args[2:], **kw, out=out,
            active=torch.tensor([flag]))
        assert w_o.data_ptr() == w_s.data_ptr()
        if flag:
            assert torch.equal(w_o, w_f) and torch.equal(u_o, u_f)
            assert torch.equal(r_o, r_f)
        else:
            assert torch.equal(w_s, t_args[0]) and torch.equal(u_s, t_args[1])
            assert float(r_o) == 0.0


def _kernel_args(args):
    """The CUDA wrapper's positional arguments from the plain version's:
    the kernel reads the compact incidence, not the padded tables."""
    return list(args[:2]) + list(args[4:])


def _wrapper_args(loss, n=2):
    arrays, ext = _loss_arrays(loss, 40, n, 16, seed=5)
    return _kernel_args(_as(arrays, _to_torch)), dict(
        ext, loss=_port_loss(loss), reg=REGS["tv"], rho=1.9,
        incidence=_incidence(arrays, ext))


@pytest.mark.parametrize("loss,k", [(loss, k) for loss in PKEYS
                                    for k in range(len(PKEYS[loss]))])
def test_wrapper_refuses_wrongly_typed_params(loss, k):
    """The CUDA wrapper checks every prox parameter's dtype (the storage
    dtype), shape and contiguity before it looks for the card."""
    args, kw = _wrapper_args(loss)
    params = list(args[2])
    good = params[k]
    params[k] = good.double()
    args[2] = tuple(params)
    with pytest.raises(TypeError, match=PKEYS[loss][k]):
        fused_pd_step(*args, **kw)
    params[k] = good[:-1]
    args[2] = tuple(params)
    with pytest.raises(ValueError, match="shape"):
        fused_pd_step(*args, **kw)
    if good.ndim > 1 and good.shape[1] > 1:
        params[k] = good.transpose(0, 1).contiguous().transpose(0, 1)
        args[2] = tuple(params)
        with pytest.raises(ValueError, match="contiguous"):
            fused_pd_step(*args, **kw)


def test_wrapper_refuses_wide_features_and_cpu_tensors():
    """No feature count is refused (n > 16 runs the wide variant): the
    checks of every loss at n = 16, 17 and 33 pass and the wrapper
    refuses the CPU tensors, the plain version's."""
    for loss in PKEYS:
        for n in (16, 17, 33):
            args, kw = _wrapper_args(loss, n=n)
            with pytest.raises(ValueError, match="CUDA"):
                fused_pd_step(*args, **kw)
    args, kw = _wrapper_args("squared")
    args[2] = args[2] + (args[2][0],)
    with pytest.raises(NotImplementedError, match="no prox"):
        fused_pd_step(*args, **dict(kw, pkeys=("b", "p", "q")))


def test_ops_routes_cpu_tensors_to_plain_version():
    """``ops.pd_step`` runs the plain version on CPU tensors and never
    counts a kernel launch; the kernel wrapper refuses them."""
    arrays, ext = _step_arrays(61, 2, 16, seed=1)
    t_args = _as(arrays, _to_torch)
    kw = dict(ext, loss=SquaredLoss(), reg=TotalVariation(), rho=1.9)
    inc = _incidence(arrays, ext)
    before = fused_pd_step.launches
    got = ops.pd_step(*t_args, **kw, incidence=inc)
    want = ref.fused_pd_step_ref(*t_args, **kw)
    for o, w in zip(got, want):
        assert torch.equal(o, w)
    assert fused_pd_step.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        fused_pd_step(*_kernel_args(t_args), **kw, incidence=inc)


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
    got = fused_pd_step(*_kernel_args(args), **kw, iters=iters,
                        incidence=_incidence(arrays, ext, "cuda"))
    want = ref.fused_pd_step_ref(*args, **kw, iters=iters)
    torch.cuda.synchronize()
    for o, w in zip(got, want):
        np.testing.assert_allclose(o.cpu().numpy(), w.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("loss", sorted(PKEYS))
@pytest.mark.parametrize("n", [17, 33])
def test_wide_steps_match_reference(loss, n):
    """Past the register tile (n > 16: the kernel's wide variant) every
    loss's plain step against the reference's jnp ``fused_pd_step_ref``
    on a banded layout, with the residual (1e-5, as
    ``test_loss_variants_match_reference``)."""
    arrays, ext = _loss_arrays(loss, 40, n, 16, seed=n)
    j = _reference()
    reg = "tv" if n % 2 else "tv2"
    kw = dict(ext, rho=1.9, compute_residual=True)
    out = ref.fused_pd_step_ref(*_as(arrays, _to_torch), loss=_port_loss(loss),
                                reg=REGS[reg], **kw)
    want = j["ref"].fused_pd_step_ref(
        *_as(arrays, j["jnp"].asarray), loss=j["losses"][loss],
        reg=j["regs"][reg], **kw)
    for o, w in zip(out, want):
        np.testing.assert_allclose(o.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_variant_keys():
    """The launch counters' keys: the earlier slices' ``"<loss>/<dtype>"``
    for the staged register tile, ``"/wide"`` past it, ``"/streamed"``
    where the parameters are read from device memory."""
    from repro_torch.kernels.pd_step import TILE_FEATURES, variant_key

    assert variant_key("squared", torch.float32, 16, True) == \
        "squared/float32"
    assert variant_key("lasso", torch.bfloat16, TILE_FEATURES + 1, True) == \
        "lasso/bfloat16/wide"
    assert variant_key("logistic", torch.float32, 2, False) == \
        "logistic/float32/streamed"
    assert variant_key("logistic", torch.float32, 64, False) == \
        "logistic/float32/wide/streamed"


KERNEL_CASES = [(61, 2, 16, 1), (103, 3, 32, 1), (64, 8, 16, 1),
                (50, 16, 32, 1), (48, 2, None, 5), (48, 16, None, 5)]


def _cuda_args(arrays, dtype):
    """The step's arrays on the card, storage ones in ``dtype``."""
    cast = (lambda t: t) if dtype == "float32" else (
        lambda t: t.to(torch.bfloat16))
    return _bf16(arrays, lambda a: _to_torch(a, "cuda"), cast)


@pytest.mark.cuda
@pytest.mark.parametrize("loss", sorted(PKEYS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("v,n,bv,iters", KERNEL_CASES)
def test_cuda_loss_variants_match_plain_version(loss, dtype, v, n, bv,
                                                iters):
    """Every loss x storage variant of the kernel against its plain
    version on the card, widths 2..16, nb > 1 and iters > 1, with the
    residual.  float32: 1e-5 (the kernel sums in slot order with fused
    multiply-adds and its own expf / sqrtf; the inner loops repeat
    that).  bfloat16: both round the same f32 values to nearest even,
    so an output may differ by one bf16 ulp at the state's scale where
    an f32 difference straddles a rounding boundary; the residual by
    that ulp over min(tau, sigma)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    arrays, ext = _loss_arrays(loss, v, n, bv, seed=v)
    args = _cuda_args(arrays, dtype)
    kw = dict(ext, loss=_port_loss(loss), reg=REGS["tv" if v % 2 else "tv2"],
              rho=1.9, iters=iters, compute_residual=True)
    before = fused_pd_step.variant_launches[f"{loss}/{dtype}"]
    got = fused_pd_step(*_kernel_args(args), **kw,
                        incidence=_incidence(arrays, ext, "cuda"))
    want = ref.fused_pd_step_ref(*args, **kw)
    torch.cuda.synchronize()
    assert fused_pd_step.variant_launches[f"{loss}/{dtype}"] == before + 1
    assert got[0].dtype == want[0].dtype == getattr(torch, dtype)
    g = [t.float().cpu().numpy() for t in got]
    w = [t.float().cpu().numpy() for t in want]
    if dtype == "float32":
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        return
    for a, b in zip(g[:2], w[:2]):
        assert np.abs(a - b).max() <= bf16_ulp(float(np.abs(b).max()))
    ulp = bf16_ulp(max(float(np.abs(x).max()) for x in w[:2]))
    steps = min(float(arrays[5][arrays[5] > 0].min()),
                float(arrays[8].min()))
    np.testing.assert_allclose(g[2], w[2], rtol=1e-5, atol=ulp / steps)


@pytest.mark.cuda
@pytest.mark.parametrize("loss", sorted(PKEYS))
def test_cuda_stop_word_and_in_place_out(loss):
    """On the card: ``out`` as the owned rows of the state gives the
    fresh result; a clear stop word writes nothing and a 0 residual."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    arrays, ext = _loss_arrays(loss, 61, 2, 16, seed=3)
    args = _cuda_args(arrays, "float32")
    kw = dict(ext, loss=_port_loss(loss), reg=REGS["tv"], rho=1.9,
              compute_residual=True, incidence=_incidence(arrays, ext, "cuda"))
    args = _kernel_args(args)
    w_f, u_f, r_f = fused_pd_step(*args, **kw)
    lo = ext["klo"] * ext["block_edges"]
    for flag in (True, False):
        w_s, u_s = args[0].clone(), args[1].clone()
        out = (w_s[:w_f.shape[0]], u_s[lo:lo + u_f.shape[0]])
        _, _, r_o = fused_pd_step(
            w_s, u_s, *args[2:], **kw, out=out,
            active=torch.tensor([flag], device="cuda"))
        torch.cuda.synchronize()
        if flag:
            assert torch.equal(out[0], w_f) and torch.equal(out[1], u_f)
            assert torch.equal(r_o, r_f)
        else:
            assert torch.equal(w_s, args[0]) and torch.equal(u_s, args[1])
            assert float(r_o) == 0.0


# the wide kernel's widths: past the register tile; 32 and 33 where the
# prox rows leave registers; and for the squared and lasso losses 239
# and 240, the last width whose staged rows fit a block and the first
# that streams (the logistic plan stages its samples, not an n x n
# matrix: its own edges are the streamed tests' below)
WIDE_NS = [17, 24, 32, 33, 64, 128]
LAST_STAGED = 239
WIDE_CASES = ([(loss, n) for loss in sorted(PKEYS) for n in WIDE_NS]
              + [(loss, n) for loss in ("lasso", "squared")
                 for n in (LAST_STAGED, LAST_STAGED + 1)])


def _f64(arrays, kw):
    """The plain version in float64 on the step's arrays: the yardstick
    of float32 rounding."""
    def cast(a):
        t = _to_torch(a, "cuda")
        return t.double() if t.is_floating_point() else t
    return ref.fused_pd_step_ref(*_as(arrays, cast), **{
        k: v for k, v in kw.items() if k != "incidence"})


def _ridge(arrays, seed):
    """The squared loss's parameters as a ridge prox (P = (I + X^T X /
    m)^-1 of m = n + 1 random samples, b ~ 0.1 N): symmetric with
    eigenvalues in (0, 1], so a long run stays bounded, where
    ``_step_arrays``' P = I + 0.1 N grows without bound."""
    rng = np.random.default_rng(seed)
    rows, n = arrays[4][0].shape
    x = rng.standard_normal((rows, n + 1, n))
    p = np.linalg.inv(np.eye(n) + np.einsum("vmn,vmk->vnk", x, x) / (n + 1))
    params = ((0.1 * rng.standard_normal((rows, n))).astype(np.float32),
              p.astype(np.float32))
    return arrays[:4] + (params,) + arrays[5:]


def _check_plain(got, want, arrays, dtype, tol=1e-5, exact=None):
    """A kernel call against the plain version: ``tol`` in float32, or
    twice the plain version's own distance from its float64 run
    (``exact``) where that is larger (at n = 128 the float32 rounding of
    a logistic Newton step, a 128 x 128 factorization eight times,
    reaches ~1e-5 by itself); one bf16 ulp at each output's scale in
    bfloat16, that ulp over min(tau, sigma) on the residual."""
    g = [t.float().cpu().numpy() for t in got]
    w = [t.float().cpu().numpy() for t in want]
    if dtype == "float32":
        x = ([None] * len(w) if exact is None
             else [t.cpu().numpy() for t in exact])
        for a, b, e in zip(g, w, x):
            lim = tol if e is None else max(tol, 2.0 * np.abs(b - e).max())
            np.testing.assert_allclose(a, b, rtol=tol, atol=lim)
        return
    for a, b in zip(g[:2], w[:2]):
        assert np.abs(a - b).max() <= bf16_ulp(float(np.abs(b).max())) + tol
    ulp = bf16_ulp(max(float(np.abs(x).max()) for x in w[:2]))
    steps = min(float(arrays[5][arrays[5] > 0].min()),
                float(arrays[8].min()))
    np.testing.assert_allclose(g[2], w[2], rtol=tol, atol=ulp / steps)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("loss,n", WIDE_CASES)
def test_cuda_wide_variants_match_plain_version(loss, dtype, n):
    """The wide kernel (n > 16, a node a warp) against its plain version
    at the widths where its layout changes (``WIDE_NS``): one call on a
    banded layout (1e-5; bf16 one ulp), counted under its ``"/wide"``
    key (``"/streamed"`` past the staging plan); the streamed variant
    forced on the same inputs gives the staged variant's bits; and 100
    iterations in one launch on the whole-graph block within 1e-4 (bf16:
    one ulp more; the squared loss with a ridge prox's P, ``_ridge``).
    Float32 limits grow to twice the plain version's own float64 distance
    where that is larger."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels.pd_step import plan_variant

    arrays, ext = _loss_arrays(loss, 40, n, 16, seed=n)
    args = _cuda_args(arrays, dtype)
    kw = dict(ext, loss=_port_loss(loss), reg=REGS["tv" if n % 2 else "tv2"],
              rho=1.9, compute_residual=True,
              incidence=_incidence(arrays, ext, "cuda"))
    kind = {"squared": 0, "lasso": 1, "logistic": 2}[loss]
    ms = arrays[4][-1].shape[1] if loss == "logistic" else 0
    key = f"{loss}/{dtype}/wide"
    if plan_variant(kind, n, ms) != "staged":
        key += "/streamed"
    if n >= LAST_STAGED:
        assert key.endswith("/streamed") == (n > LAST_STAGED)
    before = fused_pd_step.variant_launches[key]
    got = fused_pd_step(*_kernel_args(args), **kw)
    assert fused_pd_step.variant_launches[key] == before + 1
    again = fused_pd_step(*_kernel_args(args), **kw, streamed=True)
    want = ref.fused_pd_step_ref(*args, **{k: v for k, v in kw.items()
                                           if k != "incidence"})
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    _check_plain(got, want, arrays, dtype, exact=_f64(arrays, kw))

    arrays, ext = _loss_arrays(loss, 48, n, None, seed=n + 1)
    if loss == "squared":
        arrays = _ridge(arrays, seed=n)
    args = _cuda_args(arrays, dtype)
    kw.update(ext, iters=100, incidence=_incidence(arrays, ext, "cuda"))
    got = fused_pd_step(*_kernel_args(args), **kw)
    want = ref.fused_pd_step_ref(*args, **{k: v for k, v in kw.items()
                                           if k != "incidence"})
    torch.cuda.synchronize()
    _check_plain(got, want, arrays, dtype, tol=1e-4, exact=_f64(arrays, kw))


def _lanes(args, lanes):
    """``_kernel_args``-style arguments as ``lanes`` lanes of a lambda
    path: w shared, la and the duals scaled per lane."""
    scale = np.geomspace(1.0, 0.1, lanes)
    out = list(args)
    out[0] = torch.stack([args[0]] * lanes)
    out[1] = torch.stack([args[1] * float(s) for s in scale])
    out[-1] = torch.stack([args[-1] * float(s) for s in scale])
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("loss", sorted(PKEYS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("iters", [1, 5])
def test_cuda_wide_lanes_match_one_lane_launches(loss, dtype, iters):
    """Three lanes of the wide kernel at n = 33 in one launch, each lane
    bit-identical to a one-lane launch on its inputs (a node's sums run
    in one fixed order on its warp), staged and streamed."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    arrays, ext = _loss_arrays(loss, 48 if iters > 1 else 61, 33,
                               None if iters > 1 else 16, seed=iters)
    args = _kernel_args(_cuda_args(arrays, dtype))
    kw = dict(ext, loss=_port_loss(loss), reg=REGS["tv"], rho=1.9,
              iters=iters, compute_residual=True,
              incidence=_incidence(arrays, ext, "cuda"))
    largs = _lanes(args, 3)
    for streamed in (False, True):
        got = fused_pd_step(*largs, **kw, streamed=streamed)
        for k in range(3):
            one = fused_pd_step(largs[0][k], largs[1][k], *largs[2:-1],
                                largs[-1][k], **kw)
            torch.cuda.synchronize()
            for g, o in zip(got, one):
                assert torch.equal(g[k], o)


@pytest.mark.cuda
@pytest.mark.parametrize("loss", ["squared", "lasso", "logistic"])
def test_cuda_wide_streams_parameters_past_shared_memory(loss):
    """Wide nodes whose parameters pass the staging plan (squared and
    lasso at n = 256: P / Q alone is 256 KB a node; logistic at n = 32
    with 2,000 samples) run the streamed wide variant, within 1e-5 of
    the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from repro_torch.kernels.pd_step import plan_variant

    kind = {"squared": 0, "lasso": 1, "logistic": 2}[loss]
    if loss == "logistic":
        n, v = 32, 24
        arrays, ext = _loss_arrays(loss, v, n, 16, seed=7)
        rng = np.random.default_rng(7)
        params = list(arrays[4])
        rows, ms = params[2].shape[0], 2000
        mask = np.ones((rows, ms), np.float32)
        params[1] = np.full((rows, 1), ms, np.float32)
        params[2] = mask
        params[4] = rng.standard_normal((rows, ms, n)).astype(np.float32)
        params[5] = (rng.random((rows, ms)) < 0.5).astype(np.float32)
        arrays = arrays[:4] + (tuple(params),) + arrays[5:]
    else:
        n, ms = 256, 0
        arrays, ext = _loss_arrays(loss, 24, n, 16, seed=7)
    assert plan_variant(kind, n, ms if loss == "logistic" else 0) == \
        "streamed"
    args = _cuda_args(arrays, "float32")
    kw = dict(ext, loss=_port_loss(loss), reg=REGS["tv"], rho=1.9,
              compute_residual=True)
    key = f"{loss}/float32/wide/streamed"
    before = fused_pd_step.variant_launches[key]
    got = fused_pd_step(*_kernel_args(args), **kw,
                        incidence=_incidence(arrays, ext, "cuda"))
    want = ref.fused_pd_step_ref(*args, **kw)
    torch.cuda.synchronize()
    assert fused_pd_step.variant_launches[key] == before + 1
    _check_plain(got, want, arrays, "float32", exact=_f64(arrays, kw))


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
@pytest.mark.parametrize("e,n", TV_SHAPES + [(0, 2)])
def test_cuda_tv_prox_bf16_matches_plain_version(e, n):
    """Bit for bit in bfloat16: both round the bound to bf16 (nearest
    even) and clip; the clipped value is one of u, -b, b, so storing it
    as bf16 is exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    u, bound = (torch.from_numpy(a).cuda() for a in _tv_arrays(e, n, seed=e))
    u = u.to(torch.bfloat16)
    before = tv_prox.launches
    got = tv_prox(u, bound)
    want = ref.tv_prox_ref(u, bound)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
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
