"""The port's custom-op registry against ``tests/test_custom_op.py``.

The JAX file's five cases on the port's side: the default gradient
(autograd through ``fn``'s PyTorch ops), a custom backward (the constant
7 gradient), the ``twoxplus1`` fixture (here its plain version, which a
CPU tensor takes, against the JAX package's interpreted
``pallas_call``: equal), duplicate rejection and the ``cpp_extension``
guidance. The gradient cases register the same op with the JAX
registry too and hold outputs and gradients against its own on the same
inputs, with non-tensor arguments and ``**attrs`` passed through and
``res = (inputs, outputs)`` as the JAX backward receives it. Then the
port's own trap: a kernel ``fn`` (here one that
computes outside autograd, as a ``ctypes`` launch does) called on a
tensor that records its gradient raises and names ``backward=``. The
mounts are checked as the JAX registry makes them: ``ops``,
``ops.__all__``, the top level and ``torch.Tensor``, with what they
shadowed put back by ``deregister_op``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as pt
from paddle_tpu_torch import device
from paddle_tpu_torch.utils import (cpp_extension, deregister_op,
                                    register_op, registered_ops)

from _torch_custom_op.twoxplus1 import twoxplus1, twoxplus1_ref

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def clean_ops():
    """Deregister the ops a test mounts, in both registries; run on the
    CPU."""
    prev = device._current
    pt.set_device("cpu")
    before, jbefore = set(registered_ops()), set(jpt.utils.registered_ops())
    yield
    for name in set(registered_ops()) - before:
        deregister_op(name)
    for name in set(jpt.utils.registered_ops()) - jbefore:
        jpt.utils.deregister_op(name)
    pt.set_device(prev)


def _both(arrays, call, grads=True):
    """``call(api, *tensors)`` through the JAX package and the port on
    the same numpy ``arrays`` (each input records its gradient); the
    outputs of both and, with ``grads``, the inputs' gradients after
    ``out.sum().backward()``, as numpy."""
    res = []
    for api in (jpt, pt):
        xs = [api.to_tensor(a, stop_gradient=not grads) for a in arrays]
        out = call(api, *xs)
        got = [np.asarray(out.detach().numpy() if api is pt
                          else out.numpy())]
        if grads:
            out.sum().backward()
            got += [x.grad.numpy() for x in xs]
        res.append(got)
    return res


def _assert_same(jax_res, port_res):
    assert len(jax_res) == len(port_res)
    for j, p in zip(jax_res, port_res):
        np.testing.assert_allclose(p, j, rtol=1e-6, atol=1e-7)


def test_register_op_default_grad():
    import jax.numpy as jnp

    jpt.utils.register_op("fancy_relu_t",
                          lambda x: jnp.maximum(x, 0) * 1.5)

    @register_op("fancy_relu_t")
    def fancy_relu(x):
        return torch.clamp_min(x, 0) * 1.5

    a = np.array([-1.0, 2.0, 3.0], np.float32)
    jax_res, port_res = _both([a], lambda api, x: api.ops.fancy_relu_t(x))
    _assert_same(jax_res, port_res)
    np.testing.assert_allclose(port_res[1], [0.0, 1.5, 1.5])
    # also mounted at top level
    _assert_same(*_both([a], lambda api, x: api.fancy_relu_t(x * 2)))
    assert "fancy_relu_t" in pt.ops.__all__


def test_register_op_custom_backward():
    import jax.numpy as jnp

    def bwd(where):
        def run(res, cot):
            (x,), _out = res
            # deliberately nonstandard grad: constant 7 where x > 0
            return (where(x > 0, 7.0, 0.0) * cot,)
        return run

    jpt.utils.register_op("sevengrad", lambda x: jnp.maximum(x, 0),
                          backward=bwd(jnp.where), tensor_method=True)

    @register_op("sevengrad", backward=bwd(torch.where),
                 tensor_method=True)
    def sevengrad(x):
        return torch.clamp_min(x, 0)

    a = np.array([-1.0, 2.0], np.float32)
    jax_res, port_res = _both([a], lambda api, x: x.sevengrad())
    _assert_same(jax_res, port_res)
    np.testing.assert_allclose(port_res[1], [0.0, 7.0])
    deregister_op("sevengrad")
    assert not hasattr(torch.Tensor, "sevengrad")


@pytest.mark.parametrize("with_backward", [False, True])
def test_register_op_passes_arguments_through(with_backward):
    """``fn(x, k, y, *, shift)``: a Python float between two tensors and
    an attribute, with autograd's gradients or a backward that reads
    ``res = ((x, k, y), out)`` and returns one gradient a positional
    input (None for ``k``); the JAX registry and the port agree. (The
    JAX registry's ``custom_vjp`` binds no keyword arguments, so the
    attribute is left at its default where there is a backward.)"""
    import jax.numpy as jnp

    def fn(where):
        def run(x, k, y, shift=0.0):
            return x * k + where(y > 0, y, 0.0) * y + shift
        return run

    def bwd(where):
        def run(res, cot):
            (x, k, y), out = res
            assert float(k) == 3.0
            # reads the output and the float; x's gradient doubled on
            # purpose, so that the test sees which rule ran
            return (cot * k * 2 + out * 0.0, None,
                    cot * 2 * where(y > 0, y, 0.0))
        return run

    extra = dict(backward=bwd(jnp.where)) if with_backward else {}
    jpt.utils.register_op("scale_add", fn(jnp.where), **extra)
    extra = dict(backward=bwd(torch.where)) if with_backward else {}
    register_op("scale_add", fn(torch.where), **extra)
    rng = np.random.RandomState(3)
    x, y = rng.randn(2, 5).astype(np.float32)
    attrs = {} if with_backward else dict(shift=0.25)
    jax_res, port_res = _both(
        [x, y], lambda api, a, b: api.ops.scale_add(a, 3.0, b, **attrs))
    _assert_same(jax_res, port_res)
    np.testing.assert_allclose(
        port_res[0], x * 3 + np.maximum(y, 0) * y + attrs.get("shift", 0),
        rtol=1e-6)
    np.testing.assert_array_equal(port_res[1],
                                  np.full(5, 6.0 if with_backward else 3.0))
    np.testing.assert_allclose(port_res[2], 2 * np.maximum(y, 0),
                               rtol=1e-6)


def _jax_twoxplus1(a):
    """The JAX fixture: the Pallas kernel in interpret mode."""
    import jax
    from jax.experimental import pallas as pl

    def _kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...] * 2.0 + 1.0

    x = jax.numpy.asarray(a)
    return np.asarray(pl.pallas_call(
        _kernel, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        interpret=True)(x))


def test_register_op_twoxplus1_fixture():
    register_op("twoxplus1", twoxplus1)
    a = np.arange(8, dtype=np.float32).reshape(2, 4)
    out = pt.ops.twoxplus1(pt.to_tensor(a))
    want = _jax_twoxplus1(a)
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(out.numpy(), a * 2 + 1)
    # numpy in, the default place's tensor out
    np.testing.assert_array_equal(pt.ops.twoxplus1(a).numpy(), want)
    b = np.random.RandomState(0).randn(7, 13).astype(np.float32)
    np.testing.assert_array_equal(pt.twoxplus1(pt.to_tensor(b)).numpy(),
                                  _jax_twoxplus1(b))
    for dtype in (torch.bfloat16, torch.float16):
        t = pt.to_tensor(b).to(dtype)
        assert torch.equal(pt.ops.twoxplus1(t), twoxplus1_ref(t))
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        pt.ops.twoxplus1(pt.to_tensor(np.arange(3)))


def test_register_op_duplicate_rejected():
    register_op("dup_op_t", lambda x: x)
    with pytest.raises(ValueError, match="already registered"):
        register_op("dup_op_t", lambda x: x)


def test_cpp_extension_guidance():
    with pytest.raises(NotImplementedError, match="register_op"):
        cpp_extension.load("my_op", ["op.cc"])
    with pytest.raises(NotImplementedError):
        cpp_extension.CUDAExtension(["op.cu"])


def test_kernel_fn_without_backward_raises():
    def outside_autograd(x):
        # what a ctypes launch gives: a fresh tensor, no graph to x
        return torch.from_numpy(x.detach().numpy() * 2 + 1)

    register_op("kernel_like", outside_autograd)
    a = np.arange(4, dtype=np.float32)
    with pytest.raises(RuntimeError, match="backward="):
        pt.ops.kernel_like(pt.to_tensor(a, stop_gradient=False))
    # no gradient asked for: fine
    np.testing.assert_array_equal(pt.ops.kernel_like(pt.to_tensor(a)),
                                  a * 2 + 1)
    with pt.no_grad():
        pt.ops.kernel_like(pt.to_tensor(a, stop_gradient=False))
    # one input reached, another not: raises too
    register_op("half_reached", lambda x, y: x * 2 + y.detach())
    x = pt.to_tensor(a, stop_gradient=False)
    with pytest.raises(RuntimeError, match="backward="):
        pt.ops.half_reached(x, pt.to_tensor(a, stop_gradient=False))
    pt.ops.half_reached(x, pt.to_tensor(a)).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), [2.0] * 4)
    # with a backward the kernel fn trains
    register_op("kernel_trains", outside_autograd,
                backward=lambda res, cot: (2 * cot,))
    x = pt.to_tensor(a, stop_gradient=False)
    pt.ops.kernel_trains(x).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), [2.0] * 4)


def test_mounts_restore_what_they_shadow():
    flatten = pt.ops.flatten
    top_seed = pt.seed
    register_op("flatten", lambda x: x, tensor_method=True)
    register_op("seed", lambda x: x)
    assert pt.ops.flatten is not flatten and pt.seed is not top_seed
    assert torch.ones(2, 3).flatten().shape == (2, 3)    # the op's
    assert pt.ops.__all__.count("flatten") == 1
    deregister_op("flatten")
    deregister_op("seed")
    assert pt.ops.flatten is flatten and pt.seed is top_seed
    assert "seed" not in pt.ops.__all__ and "flatten" in pt.ops.__all__
    assert torch.ones(2, 3).flatten().shape == (6,)
    with pytest.raises(KeyError):
        deregister_op("seed")
    # paddle_tpu's registry is not touched by the port's
    assert "flatten" not in jpt.utils.registered_ops()
