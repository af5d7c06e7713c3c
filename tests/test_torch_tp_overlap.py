"""The port's TP ring primitives (``paddle_tpu_torch/fusion/overlap_mm.py``
over a ``Ring`` of CPU devices) against the JAX package's
(``paddle_tpu/fusion/overlap_mm.py`` in ``shard_map`` over the virtual
CPU devices that tests/conftest.py sets up), on the same numpy inputs.

Tolerances: loss ``sum(out)``, dx and dw in f32 at rtol 1e-5, atol 1e-6
(the JAX tests hold the 2-rank ring bitwise against the serial
composition; the port sums its matmuls in PyTorch's order, so it is held
within tolerances). The ring gather and the plain ring step's shift are
pure data movement and are held bitwise.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from paddle_tpu.fusion import overlap_mm as jom
from paddle_tpu_torch.distributed import Ring
from paddle_tpu_torch.fusion import overlap_mm as tom
from paddle_tpu_torch.incubate.nn.cuda import ring as kring

# tiny shapes: one torch thread a test process (more only contend
# with the other pytest-xdist workers for the cores)
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def _rand(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("mp",))


def _jax_loss_grads(fn, x, w):
    # under jit: the JAX ring traced once, not dispatched op by op
    val, grads = jax.jit(jax.value_and_grad(
        lambda a, b: jnp.sum(fn(a, b)), argnums=(0, 1)))(jnp.asarray(x),
                                                          jnp.asarray(w))
    return np.asarray(val), [np.asarray(g) for g in grads]


def _torch_loss_grads(fn, x, w):
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    loss = fn(xt, wt).sum()
    gx, gw = torch.autograd.grad(loss, [xt, wt])
    return loss.detach().numpy(), [gx.numpy(), gw.numpy()]


def _assert_close(want, got, what):
    np.testing.assert_allclose(got[0], want[0], err_msg=what + " loss", **TOL)
    for name, a, b in zip(("dx", "dw"), want[1], got[1]):
        np.testing.assert_allclose(b, a, err_msg="%s %s" % (what, name),
                                   **TOL)


# (mp, chunks, x shape): the JAX tests' shapes, mp 2 at chunks 1, 2, 4
# and mp 4 at chunks 2. ``chunks`` splits the JAX ring's local GEMMs; the
# port's ring runs each block in one GEMM (no chunk count), so every
# case holds it against the JAX result at that count.
CASES = [(2, 1, (4, 6, 16)), (2, 2, (4, 6, 16)), (2, 4, (4, 6, 16)),
         (4, 2, (8, 4, 16))]


@pytest.mark.parametrize("mp,chunks,shape", CASES)
def test_sharded_all_gather_matmul_matches_jax(mp, chunks, shape):
    x, w = _rand(shape, 2), _rand((16, 8), 3, 0.1)
    want = _jax_loss_grads(
        lambda a, b: jom.sharded_all_gather_matmul(a, b, mesh=_mesh(mp),
                                                   chunks=chunks), x, w)
    ring = Ring(["cpu"] * mp)
    got = _torch_loss_grads(
        lambda a, b: tom.sharded_all_gather_matmul(a, b, ring=ring), x, w)
    _assert_close(want, got, "agmm mp=%d chunks=%d" % (mp, chunks))


@pytest.mark.parametrize("mp,chunks,shape", CASES)
def test_sharded_matmul_reduce_scatter_matches_jax(mp, chunks, shape):
    x, w = _rand(shape, 4), _rand((16, 8), 5, 0.1)
    want = _jax_loss_grads(
        lambda a, b: jom.sharded_matmul_reduce_scatter(
            a, b, mesh=_mesh(mp), chunks=chunks), x, w)
    ring = Ring(["cpu"] * mp)
    got = _torch_loss_grads(
        lambda a, b: tom.sharded_matmul_reduce_scatter(a, b, ring=ring),
        x, w)
    _assert_close(want, got, "mmrs mp=%d chunks=%d" % (mp, chunks))


@pytest.mark.parametrize("op", ["agmm", "mmrs"])
def test_off_mode_is_the_serial_composition(op):
    """PADDLE_TPU_TP_OVERLAP=off: the port runs gather-then-matmul (or
    matmul-then-reduce-scatter), the JAX package its ring; both agree."""
    x, w = _rand((8, 4, 16), 6), _rand((16, 8), 7, 0.1)
    jfn = jom.sharded_all_gather_matmul if op == "agmm" else \
        jom.sharded_matmul_reduce_scatter
    tfn = tom.sharded_all_gather_matmul if op == "agmm" else \
        tom.sharded_matmul_reduce_scatter
    want = _jax_loss_grads(lambda a, b: jfn(a, b, mesh=_mesh(4)), x, w)
    ring = Ring(["cpu"] * 4)
    with tom.override(tp_overlap="off"):
        assert tom.mode() == "off"
        got = _torch_loss_grads(lambda a, b: tfn(a, b, ring=ring), x, w)
    _assert_close(want, got, op + " off")


def _jax_ring(fn, mp, out_specs, *arrays):
    return jax.jit(jom._shard_map(fn, _mesh(mp),
                                  tuple(P("mp") for _ in arrays),
                                  out_specs))(*[jnp.asarray(a)
                                                for a in arrays])


@pytest.mark.parametrize("mp", [2, 4])
def test_mm_step_ref_matches_the_jax_ring_step(mp):
    """K9's plain version against the JAX ring step's function: the
    ``_ppermute_step`` of ``buf`` plus ``_chunked_rows_mm(buf, w, 1)``,
    per rank; 3-D buffers as the JAX tests use them."""
    bufs, ws = _rand((mp * 4, 6, 16), 8), _rand((mp * 16, 8), 9, 0.1)

    def body(buf, w):
        return (jom._chunked_rows_mm(buf, w, 1),
                jom._ppermute_step(buf, "mp", mp))

    part, nxt = _jax_ring(body, mp, (P("mp"), P("mp")), bufs, ws)
    ring = Ring(["cpu"] * mp)
    tb = list(torch.from_numpy(bufs).chunk(mp))
    tw = list(torch.from_numpy(ws).chunk(mp))
    parts, nexts = kring.mm_step_ref(tb, tw, ring)
    np.testing.assert_allclose(torch.cat(parts).numpy(), np.asarray(part),
                               **TOL)
    assert np.array_equal(torch.cat(nexts).numpy(), np.asarray(nxt))
    assert all(a is not b for a, b in zip(nexts, tb))


@pytest.mark.parametrize("mp", [2, 4])
def test_ring_gather_matches_jax(mp):
    x = _rand((mp * 3, 5, 8), 10)
    want = _jax_ring(lambda a: jom._ring_gather(a, "mp", mp), mp, P("mp"),
                     x)
    ring = Ring(["cpu"] * mp)
    got = tom._ring_gather(list(torch.from_numpy(x).chunk(mp)), ring)
    assert np.array_equal(torch.cat(got).numpy(), np.asarray(want))


def test_knobs_parse_as_the_jax_package(monkeypatch):
    for raw in ("", "auto", "on", "pallas", "off", " OFF "):
        monkeypatch.setenv("PADDLE_TPU_TP_OVERLAP", raw)
        assert tom.mode() == jom.mode(), raw
    monkeypatch.setenv("PADDLE_TPU_TP_OVERLAP", "sideways")
    for m in (tom, jom):
        with pytest.raises(ValueError):
            m.mode()
    monkeypatch.setenv("PADDLE_TPU_TP_OVERLAP", "off")
    with tom.override(tp_overlap="pallas"):
        assert tom.mode() == "pallas"
        with tom.override(tp_overlap="auto"):
            assert tom.mode() == "on"
        assert tom.mode() == "pallas"
    assert tom.mode() == "off"


def test_quant_mode_is_not_ported():
    ring = Ring(["cpu"] * 2)
    x, w = torch.ones(4, 8), torch.ones(8, 8)
    for fn in (tom.sharded_all_gather_matmul,
               tom.sharded_matmul_reduce_scatter):
        with pytest.raises(NotImplementedError):
            fn(x, w, ring=ring, quant_mode="int8")


def test_cpu_ring_launches_no_kernel():
    """CPU tensors take the plain ring step in every mode: K9's count
    does not move."""
    before = kring.mm_step.launches
    x, w = _rand((4, 6, 16), 11), _rand((16, 8), 12, 0.1)
    with tom.override(tp_overlap="pallas"):
        tom.sharded_all_gather_matmul(torch.from_numpy(x),
                                      torch.from_numpy(w),
                                      ring=Ring(["cpu"] * 2))
    assert kring.mm_step.launches == before
