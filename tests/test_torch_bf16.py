"""``--dtype bfloat16`` in the port against flax's ``dtype=jnp.bfloat16``
on the CPU, model by model at a small size, the same weights on both
sides (``convert.from_jax_params``), one batch from one numpy seed: the
logits, the loss and the flat gradient (``ravel_pytree``'s order).

Parameters stay float32 on both sides and the gradients arrive in
float32, so the flat gradient, the selection and the optimizer run as
in float32. The two frameworks round bfloat16 at different points (XLA
on the CPU fuses elementwise chains and rounds once at their end, torch
rounds after each op; cuDNN's LSTM keeps its carry in bfloat16 where
flax's AN4 cells keep theirs float32), so the comparison is by relative
error, ||port - jax|| / ||jax||:

* logits within ``LOGITS_RTOL`` (0.0251 the largest measured, VGG-16)
  and the loss within ``LOSS_RTOL``;
* the flat gradient: at these batches (2 to 4) bfloat16 moves a vision
  model's gradient far from its float32 value on either side (flax's
  own drift measured 0.14 to 0.50: BatchNorm over a few values and ReLU
  inputs that round across 0), so the port's bfloat16 gradient is held
  to flax's within ``GRAD_RATIO`` times flax's own bfloat16 drift from
  its float32 gradient (0.25 to 1.02 of it measured), and the port's
  drift from flax's float32 gradient to the same bound (0.23 to 1.12
  measured).

Dropout is off on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from jax.flatten_util import ravel_pytree

from gtopkssgd_tpu.models.alexnet import AlexNet as JaxAlexNet
from gtopkssgd_tpu.models.lstm import PTBLSTM as JaxPTBLSTM
from gtopkssgd_tpu.models.lstman4 import DeepSpeechAN4 as JaxAN4
from gtopkssgd_tpu.models.resnet import ResNetCIFAR as JaxResNetCIFAR
from gtopkssgd_tpu.models.resnet import ResNetImageNet as JaxResNet
from gtopkssgd_tpu.models.vgg import VGG16 as JaxVGG
from gtopkssgd_tpu_torch.convert import flat_layout, from_jax_params
from gtopkssgd_tpu_torch.ctc import ctc_loss
from gtopkssgd_tpu_torch.models import (
    AlexNet,
    DeepSpeechAN4,
    PTBLSTM,
    ResNetCIFAR,
    ResNetImageNet,
    VGG16,
)
from gtopkssgd_tpu_torch.trainer import TrainConfig, Trainer

torch.set_num_threads(2)
BF16 = jnp.bfloat16

LOGITS_RTOL = 0.05
LOSS_RTOL = 0.02
GRAD_RATIO = 1.5


def _perturb(tree, rng):
    """BatchNorm scales and variances to 1 + 0.1 |N|, biases and means to
    0.1 N (no branch starts at zero); kernels unchanged."""
    def leaf(path, a):
        key = path[-1].key
        a = np.asarray(a)
        if key in ("scale", "var"):
            return 1.0 + 0.1 * np.abs(rng.standard_normal(a.shape)).astype(
                np.float32)
        if key in ("bias", "mean"):
            return 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _vision(make_jax, make_port, shape, classes=10):
    """(jax fn(dtype) -> (loss, logits, grads), port fn(dtype) -> (loss,
    logits, model)) for a vision model in train mode."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    y = rng.integers(0, classes, shape[0]).astype(np.int32)
    v = make_jax(jnp.float32).init(jax.random.PRNGKey(1), jnp.asarray(x))
    params = _perturb(v["params"], rng)
    stats = _perturb(v.get("batch_stats", {}), rng)

    def run_jax(dtype):
        jm = make_jax(dtype)

        def loss_fn(p):
            logits, _ = jm.apply({"params": p, "batch_stats": stats},
                                 jnp.asarray(x), train=True,
                                 mutable=["batch_stats"])
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, jnp.asarray(y)).mean(), logits

        (loss, logits), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return loss, logits, g

    def run_port(dtype):
        tm = make_port(dtype)
        tm.load_state_dict(from_jax_params(params, stats))
        tm.train()
        logits = tm(torch.from_numpy(x))
        loss = F.cross_entropy(logits, torch.from_numpy(y).long())
        loss.backward()
        return loss, logits, tm

    return run_jax, run_port


def _ptb():
    rng = np.random.default_rng(0)
    vocab, hidden = 64, 16
    tokens = rng.integers(0, vocab, (3, 7)).astype(np.int32)
    targets = rng.integers(0, vocab, (3, 7)).astype(np.int32)
    make_jax = lambda dt: JaxPTBLSTM(  # noqa: E731
        vocab_size=vocab, hidden_size=hidden, dropout_rate=0.0, dtype=dt)
    params = _perturb(make_jax(jnp.float32).init(
        jax.random.PRNGKey(1), jnp.asarray(tokens))["params"], rng)

    def run_jax(dtype):
        jm = make_jax(dtype)

        def loss_fn(p):
            logits, _ = jm.apply({"params": p}, jnp.asarray(tokens))
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, jnp.asarray(targets)).mean(), logits

        (loss, logits), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return loss, logits, g

    def run_port(dtype):
        tm = PTBLSTM(vocab_size=vocab, hidden_size=hidden, dropout_rate=0.0,
                     dtype=dtype)
        tm.load_state_dict(from_jax_params(params))
        logits, carry = tm(torch.from_numpy(tokens).long())
        assert all(t.dtype == dtype for pair in carry for t in pair)
        loss = F.cross_entropy(logits.reshape(-1, vocab),
                               torch.from_numpy(targets).long().reshape(-1))
        loss.backward()
        return loss, logits, tm

    return run_jax, run_port


def _an4():
    rng = np.random.default_rng(2)
    lengths = np.asarray([48, 31, 17], np.int32)
    x = np.zeros((3, 48, 161), np.float32)
    for b, n in enumerate(lengths):
        x[b, :n] = rng.standard_normal((n, 161))
    labels = rng.integers(1, 29, (3, 4)).astype(np.int32)
    label_lengths = np.asarray([4, 3, 2], np.int32)
    make_jax = lambda dt: JaxAN4(rnn_hidden=8, rnn_layers=2,  # noqa: E731
                                 dtype=dt)
    v = make_jax(jnp.float32).init(jax.random.PRNGKey(4), jnp.asarray(x),
                                   jnp.asarray(lengths))
    params, stats = _perturb(v["params"], rng), _perturb(v["batch_stats"],
                                                          rng)
    out_len = np.asarray(DeepSpeechAN4.output_length(lengths))

    def run_jax(dtype):
        jm = make_jax(dtype)

        def loss_fn(p):
            logits, _ = jm.apply({"params": p, "batch_stats": stats},
                                 jnp.asarray(x), jnp.asarray(lengths),
                                 train=True, mutable=["batch_stats"])
            t = logits.shape[1]
            lpad = (jnp.arange(t)[None] >= out_len[:, None]).astype(
                jnp.float32)
            ypad = (jnp.arange(4)[None] >= label_lengths[:, None]).astype(
                jnp.float32)
            return optax.ctc_loss(logits, lpad, jnp.asarray(labels),
                                  ypad).mean(), logits

        (loss, logits), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return loss, logits, g

    def run_port(dtype):
        tm = DeepSpeechAN4(rnn_hidden=8, rnn_layers=2, dtype=dtype)
        tm.load_state_dict(from_jax_params(params, stats))
        tm.train()
        lt = torch.from_numpy(lengths)
        logits = tm(torch.from_numpy(x), lt)
        loss = ctc_loss(logits, tm.output_length(lt),
                        torch.from_numpy(labels),
                        torch.from_numpy(label_lengths))
        loss.backward()
        return loss, logits, tm

    return run_jax, run_port


SMALL = (1, 1, 1, 1)
CASES = {
    "resnet20": lambda: _vision(
        lambda dt: JaxResNetCIFAR(depth=20, dtype=dt),
        lambda dt: ResNetCIFAR(depth=20, dtype=dt), (4, 32, 32, 3)),
    "vgg16": lambda: _vision(
        lambda dt: JaxVGG(dropout_rate=0.0, dtype=dt),
        lambda dt: VGG16(dropout_rate=0.0, dtype=dt), (4, 32, 32, 3)),
    "alexnet": lambda: _vision(
        lambda dt: JaxAlexNet(num_classes=10, dropout_rate=0.0, dtype=dt),
        lambda dt: AlexNet(num_classes=10, dropout_rate=0.0, image_size=64,
                           dtype=dt), (4, 64, 64, 3)),
    "resnet50": lambda: _vision(
        lambda dt: JaxResNet(stage_sizes=SMALL, num_classes=10, dtype=dt),
        lambda dt: ResNetImageNet(stage_sizes=SMALL, num_classes=10,
                                  dtype=dt), (2, 64, 64, 3)),
    "lstm": _ptb,
    "lstman4": _an4,
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    run_jax, run_port = CASES[request.param]()
    jloss, jlogits, jgrads = run_jax(BF16)
    floss, flogits, fgrads = run_jax(jnp.float32)
    tloss, tlogits, tm = run_port(torch.bfloat16)
    lay = flat_layout(tm)
    grads = [p.grad for p in lay.params]
    return dict(name=request.param, jloss=float(jloss),
                jlogits=np.asarray(jlogits), jgrads=np.asarray(
                    ravel_pytree(jgrads)[0]), floss=float(floss),
                flogits=np.asarray(flogits),
                fgrads=np.asarray(ravel_pytree(fgrads)[0]),
                tloss=tloss, tlogits=tlogits, tm=tm, grads=grads,
                tflat=lay.ravel(grads).numpy())


def test_parameters_and_gradients_stay_float32(case):
    tm = case["tm"]
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert all(g.dtype == torch.float32 for g in case["grads"])
    assert case["tlogits"].dtype == torch.float32
    assert case["tloss"].dtype == torch.float32
    assert case["jgrads"].dtype == np.float32


def test_logits_loss_and_gradient_match_flax_bf16(case):
    logits = _rel(case["tlogits"].detach().numpy(), case["jlogits"])
    loss = abs(float(case["tloss"]) - case["jloss"]) / abs(case["jloss"])
    assert logits <= LOGITS_RTOL, logits
    assert loss <= LOSS_RTOL, loss
    # bfloat16 is what both computed: flax's logits are off its float32
    # run by a bfloat16-sized error.
    assert _rel(case["jlogits"], case["flogits"]) > 1e-4
    drift = _rel(case["jgrads"], case["fgrads"])
    grad = _rel(case["tflat"], case["jgrads"])
    port_drift = _rel(case["tflat"], case["fgrads"])
    assert grad <= GRAD_RATIO * drift, (grad, drift)
    assert port_drift <= GRAD_RATIO * drift, (port_drift, drift)


@pytest.mark.parametrize("compression,method", [("gtopk", "twostage"),
                                                ("gtopk", "pallas"),
                                                (None, "exact")])
def test_bf16_trainer_feeds_the_selection_float32(compression, method,
                                                  monkeypatch):
    """The trainer at bfloat16: the flat gradient and the residual that
    reach the selection are float32, and the step trains."""
    from gtopkssgd_tpu_torch.ops import topk

    seen = []
    real = topk.select_tau

    def spy(x, k, m="auto", *, residual=None):
        seen.append((x.dtype, None if residual is None else residual.dtype))
        return real(x, k, m, residual=residual)

    monkeypatch.setattr("gtopkssgd_tpu_torch.compression.select_tau", spy)
    with Trainer(TrainConfig(device="cpu", dtype="bfloat16", batch_size=4,
                             compression=compression, density=0.01,
                             topk_method=method, prefetch=0)) as t:
        assert t.model.compute_dtype == torch.bfloat16
        losses = t.train(2)["losses"]
        assert t.optimizer.flat_grad.dtype == torch.float32
    assert np.all(np.isfinite(losses))
    if compression:
        assert seen == [(torch.float32, torch.float32)] * 2
    else:
        assert not seen
