"""The port's BERT family and the layers it stands on, against the JAX
package on the CPU.

The same numpy weights (from a seed) go into the JAX package's
``BertForPreTraining(bert_tiny())`` and the port's, through
``convert.layer_params`` under the JAX ``state_dict`` names (the tied
MLM decoder weight is listed once, as the word embeddings), and the
same batch (2 x 16 tokens, 4 MLM labels a row, NSP labels) through
both, dropout 0 in training mode. Tolerances, f32: the layers
(``Embedding`` with ``padding_idx``, ``LayerNorm`` at eps 1e-12,
``gelu`` exact and approximate, ``tanh``, ``Dropout`` in eval) 1e-5,
outputs and gradients; the encoder, the pooled output, the MLM / NSP
logits and the pretraining loss, with and without a 2-D key mask, 1e-4;
every parameter's gradient (the tied one included) 1e-4; over 3
``AdamW`` steps the losses 1e-4 and each parameter tensor 1e-4 in
relative L2, a tensor the steps moved by at least 4x that. Not element
by element: Adam divides each gradient by its own magnitude, so an
element whose gradient nearly cancels over the batch moves by a
fraction of the learning rate that the two packages' roundings set
apart (the pooler's weight: 2.5e-4 at one element). The keys' biases,
whose gradient is rounding noise alone, are held to the learning rate
(``test_key_bias_gradient_is_rounding_noise``). The forward hooks: Paddle's
``register_forward_pre_hook`` / ``register_forward_post_hook`` change
the inputs and outputs as the JAX layer's do, and their removers undo
them.

The JAX models are built with their initializers swapped for zeros (the
weights are set from numpy anyway) and run eagerly, as
``tests/test_bert_vision.py`` runs them; one fixture runs them once for
the module.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as jpt
import paddle_tpu.nn.functional as JF
from paddle_tpu.models import BertForPreTraining as JBertForPreTraining
from paddle_tpu.models import BertForSequenceClassification as JBertCls
from paddle_tpu.models import BertPretrainingCriterion as JCriterion
from paddle_tpu.models import bert_tiny as jbert_tiny
from paddle_tpu.nn import initializer as jinit

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch import convert, device
from paddle_tpu_torch.models import (BertForPreTraining,
                                     BertForSequenceClassification,
                                     BertPretrainingCriterion, bert_tiny)

torch.set_num_threads(1)

LAYER = dict(rtol=1e-5, atol=1e-5)
MODEL = dict(rtol=1e-4, atol=1e-4)
STEPS = 3
LR = 5e-3
NO_DROPOUT = dict(hidden_dropout=0.0, attention_dropout=0.0)
CHECK_MOVE = 4      # the steps move a parameter by 4x its error or more


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = device._current
    pt.set_device("cpu")
    yield
    pt.set_device(prev)


@pytest.fixture(scope="module")
def zero_init():
    """The JAX initializers as zeros while the module's models are built."""
    mp = pytest.MonkeyPatch()
    for cls in (jinit.Constant, jinit.Uniform, jinit.XavierNormal,
                jinit.Normal):
        mp.setattr(cls, "__call__", lambda self, shape, dtype=jnp.float32:
                   jnp.asarray(np.zeros(tuple(shape), np.float32)).astype(
                       dtype))
    yield
    mp.undo()


def rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.numpy())


def random_state(layer, seed):
    """Numpy weights for every entry of ``layer.state_dict()``: norms'
    weights near 1, biases near 0, matrices at Xavier's scale."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, t in layer.state_dict().items():
        shape = tuple(t.shape)
        if name.endswith("bias"):
            a = 0.1 * rng.randn(*shape)
        elif len(shape) == 1:
            a = 1.0 + 0.1 * rng.randn(*shape)
        else:
            a = rng.randn(*shape) * np.sqrt(2.0 / sum(shape))
        out[name] = a.astype(np.float32)
    return out


def pair(jax_layer, port_layer, seed=0):
    """The same random weights in both layers."""
    state = random_state(jax_layer, seed)
    jax_layer.set_state_dict(state)
    missing, unexpected = port_layer.set_state_dict(
        convert.layer_params(state, port_layer))
    assert not missing and not unexpected
    return state


def batch(cfg, seed=0, b=2, s=16):
    """Token ids, MLM labels (4 a row, -100 elsewhere), NSP labels and a
    key mask that pads the first row's last 4 tokens."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)
    mlm = np.full((b, s), -100, np.int64)
    mlm[:, :4] = rng.randint(0, cfg.vocab_size, (b, 4))
    nsp = rng.randint(0, 2, (b,)).astype(np.int32)
    mask = np.ones((b, s), np.float32)
    mask[0, s - 4:] = 0.0
    return ids, mlm, nsp, mask


# ------------------------------------------------------------ layers
def test_embedding_with_padding_idx(zero_init):
    je = jpt.nn.Embedding(12, 8, padding_idx=3)
    pe = pt.nn.Embedding(12, 8, padding_idx=3)
    assert not _np(pe.weight)[3].any()
    pair(je, pe, seed=1)
    ids = np.array([[3, 1, 4, 3], [5, 9, 2, 6]], np.int64)
    jo, po = je(jpt.to_tensor(ids)), pe(pt.to_tensor(ids))
    np.testing.assert_allclose(_np(po), _np(jo), **LAYER)
    assert not _np(po)[0, 0].any() and not _np(po)[0, 3].any()
    jo.sum().backward()
    (po * 1.0).sum().backward()
    np.testing.assert_allclose(_np(pe.weight.grad), _np(je.weight.grad),
                               **LAYER)
    assert not _np(pe.weight.grad)[3].any()


def test_layer_norm_eps_1e12(zero_init):
    jl = jpt.nn.LayerNorm(32, epsilon=1e-12)
    pl = pt.nn.LayerNorm(32, epsilon=1e-12)
    pair(jl, pl, seed=2)
    x = (np.random.RandomState(3).randn(4, 5, 32) * 3 + 1).astype(np.float32)
    jx = jpt.to_tensor(x, stop_gradient=False)
    px = pt.to_tensor(x, stop_gradient=False)
    jo, po = jl(jx), pl(px)
    np.testing.assert_allclose(_np(po), _np(jo), **LAYER)
    w = np.random.RandomState(4).randn(*x.shape).astype(np.float32)
    (jo * jpt.to_tensor(w)).sum().backward()
    (po * pt.to_tensor(w)).sum().backward()
    np.testing.assert_allclose(_np(px.grad), _np(jx.grad), **LAYER)
    for name in ("weight", "bias"):
        np.testing.assert_allclose(_np(getattr(pl, name).grad),
                                   _np(getattr(jl, name).grad),
                                   err_msg=name, **LAYER)


@pytest.mark.parametrize("fn", ["gelu", "gelu_approximate", "tanh",
                                "GELU", "Tanh", "Dropout_eval"])
def test_activations_and_dropout(fn):
    x = (np.random.RandomState(5).randn(6, 7) * 2).astype(np.float32)
    jx = jpt.to_tensor(x, stop_gradient=False)
    px = pt.to_tensor(x, stop_gradient=False)
    if fn == "gelu_approximate":
        jo, po = JF.gelu(jx, approximate=True), F.gelu(px, approximate=True)
    elif fn in ("gelu", "tanh"):
        jo, po = getattr(JF, fn)(jx), getattr(F, fn)(px)
    elif fn == "Dropout_eval":
        jd, pd = jpt.nn.Dropout(0.5), pt.nn.Dropout(0.5)
        jd.eval()
        pd.eval()
        jo, po = jd(jx), pd(px)
    else:
        jo, po = getattr(jpt.nn, fn)()(jx), getattr(pt.nn, fn)()(px)
    np.testing.assert_allclose(_np(po), _np(jo), **LAYER)
    (jo * jo).sum().backward()
    (po * po).sum().backward()
    np.testing.assert_allclose(_np(px.grad), _np(jx.grad), **LAYER)


def test_layer_list_and_sublayers():
    layers = pt.nn.LayerList([pt.nn.Linear(4, 4), pt.nn.GELU()])
    layers.append(pt.nn.Tanh())
    assert len(layers) == 3 and isinstance(layers[-1], pt.nn.Tanh)
    assert [type(x).__name__ for x in layers.sublayers(include_self=True)
            ] == ["LayerList", "Linear", "GELU", "Tanh"]
    assert len(layers.sublayers()) == 3
    assert list(layers.state_dict()) == ["0.weight", "0.bias"]


def test_forward_hooks_and_removers(zero_init):
    jl, pl = jpt.nn.Linear(5, 3), pt.nn.Linear(5, 3)
    pair(jl, pl, seed=6)
    x = np.random.RandomState(7).randn(2, 5).astype(np.float32)
    seen = {"jax": [], "port": []}
    removers = {}
    for key, layer in (("jax", jl), ("port", pl)):
        def pre(lay, inputs, key=key, layer=layer):
            assert lay is layer and isinstance(inputs, tuple)
            seen[key].append("pre")
            return (inputs[0] * 2.0,)

        def post(lay, inputs, outputs, key=key):
            seen[key].append("post")
            return outputs + 1.0

        removers[key] = (layer.register_forward_pre_hook(pre),
                         layer.register_forward_post_hook(post))
    jo, po = jl(jpt.to_tensor(x)), pl(pt.to_tensor(x))
    np.testing.assert_allclose(_np(po), _np(jo), **LAYER)
    np.testing.assert_allclose(
        _np(po), x * 2.0 @ _np(pl.weight) + _np(pl.bias) + 1.0, **LAYER)
    assert seen["port"] == seen["jax"] == ["pre", "post"]
    for key in removers:
        for r in removers[key]:
            r.remove()
    jo, po = jl(jpt.to_tensor(x)), pl(pt.to_tensor(x))
    np.testing.assert_allclose(_np(po), _np(jo), **LAYER)
    np.testing.assert_allclose(_np(po), x @ _np(pl.weight) + _np(pl.bias),
                               **LAYER)
    assert seen["port"] == ["pre", "post"]


# ------------------------------------------------------------ BERT
def test_tied_decoder_weight_listed_once():
    m = BertForPreTraining(bert_tiny())
    w = m.bert.embeddings.word_embeddings.weight
    assert m.cls.decoder_weight is w
    assert sum(p is w for p in m.parameters()) == 1
    assert "cls.decoder_weight" not in m.state_dict()
    assert len(m.parameters()) == len(m.state_dict()) == 46


@pytest.fixture(scope="module")
def bert_runs(zero_init):
    """Both packages' bert_tiny from the same weights on the same batch:
    the outputs without and with the key mask, the gradients of the
    first loss, then 3 AdamW steps (the first from those gradients)."""
    prev = device._current
    pt.set_device("cpu")
    try:
        jcfg, pcfg = jbert_tiny(**NO_DROPOUT), bert_tiny(**NO_DROPOUT)
        jm, pm = JBertForPreTraining(jcfg), BertForPreTraining(pcfg)
        init = pair(jm, pm, seed=8)
        jcrit, pcrit = JCriterion(jcfg.vocab_size), \
            BertPretrainingCriterion(pcfg.vocab_size)
        ids, mlm, nsp, mask = batch(pcfg)
        out = {"jax": {}, "port": {}}
        for key, m, crit, to in (("jax", jm, jcrit, jpt.to_tensor),
                                 ("port", pm, pcrit, pt.to_tensor)):
            res = out[key]
            for masked in (False, True):
                kw = {"attention_mask": to(mask)} if masked else {}
                tag = "masked " if masked else ""
                seq, pooled = m.bert(to(ids), **kw)
                scores, rel = m(to(ids), **kw)
                loss = crit(scores, rel, to(mlm), to(nsp))
                res.update({tag + "encoder": _np(seq),
                            tag + "pooled": _np(pooled),
                            tag + "mlm logits": _np(scores),
                            tag + "nsp logits": _np(rel),
                            tag + "loss": _np(loss)})
            opt = (jpt if key == "jax" else pt).optimizer.AdamW(
                learning_rate=LR, parameters=m.parameters())
            losses = []
            for step in range(STEPS):
                scores, rel = m(to(ids))
                loss = crit(scores, rel, to(mlm), to(nsp))
                loss.backward()
                if step == 0:
                    res["grads"] = {n: _np(p.grad)
                                    for n, p in m.named_parameters()}
                opt.step()
                opt.clear_grad()
                losses.append(float(_np(loss)))
            res["losses"] = np.array(losses)
            res["params"] = {n: _np(p).copy()
                             for n, p in m.named_parameters()}
        out["init"] = init
        return out
    finally:
        pt.set_device(prev)


@pytest.mark.parametrize("what", [
    "encoder", "pooled", "mlm logits", "nsp logits", "loss",
    "masked encoder", "masked pooled", "masked mlm logits",
    "masked nsp logits", "masked loss"])
def test_bert_tiny_outputs(bert_runs, what):
    got, want = bert_runs["port"][what], bert_runs["jax"][what]
    assert np.all(np.isfinite(want))
    np.testing.assert_allclose(got, want, **MODEL)


def test_the_mask_changes_the_padded_row(bert_runs):
    r = bert_runs["port"]
    assert not np.allclose(r["masked encoder"][0], r["encoder"][0],
                           rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(r["masked encoder"][1], r["encoder"][1],
                               **MODEL)


def test_bert_tiny_gradients(bert_runs):
    got, want = bert_runs["port"]["grads"], bert_runs["jax"]["grads"]
    assert list(got) == list(want) and len(got) == 46
    tied = "bert.embeddings.word_embeddings.weight"
    assert np.abs(want[tied]).max() > 0
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name,
                                   **MODEL)


def test_bert_tiny_adamw_steps(bert_runs):
    got, want = bert_runs["port"], bert_runs["jax"]
    np.testing.assert_allclose(got["losses"], want["losses"], **MODEL)
    assert want["losses"][-1] < want["losses"][0]
    bad = []
    for name, w in want["params"].items():
        if name.endswith("k_proj.bias"):
            continue
        err = rel_l2(got["params"][name], w)
        move = rel_l2(bert_runs["init"][name], w)
        if not (err <= MODEL["rtol"] and move >= CHECK_MOVE * err):
            bad.append((name, err, move))
    assert not bad, bad


def test_key_bias_gradient_is_rounding_noise(bert_runs):
    """The keys' bias adds ``q . b`` to a whole row of scores, which the
    softmax cancels: its gradient is 0 but for rounding, in both
    packages, and Adam turns that noise into steps of up to the learning
    rate, of either sign. So those biases are held to that, not 1e-4."""
    got, want = bert_runs["port"], bert_runs["jax"]
    for name in want["params"]:
        if not name.endswith("k_proj.bias"):
            continue
        g = np.abs(want["grads"][name]).max()
        scale = np.abs(want["grads"][name.replace("k_proj", "q_proj")]).max()
        assert g < 1e-4 * scale, (name, g, scale)
        assert np.abs(got["params"][name] - want["params"][name]).max() \
            <= 2 * LR * STEPS, name


def test_sequence_classification(zero_init):
    jcfg, pcfg = jbert_tiny(**NO_DROPOUT), bert_tiny(**NO_DROPOUT)
    jm, pm = JBertCls(jcfg, num_classes=3), \
        BertForSequenceClassification(pcfg, num_classes=3)
    pair(jm, pm, seed=9)
    ids = batch(pcfg, seed=10)[0]
    np.testing.assert_allclose(_np(pm(pt.to_tensor(ids))),
                               _np(jm(jpt.to_tensor(ids))), **MODEL)
