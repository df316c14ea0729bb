"""The port's recurrent zoo against the JAX package: the PTB and AN4
pipelines, the PTB LSTM and the AN4 DeepSpeech model with the weights
carried by ``convert.from_jax_params``, the flat layout, the CTC loss and
the greedy decode.

Pipelines: batches bitwise equal to the JAX pipelines', synthetic and on
the real-format fixtures of ``tests/fixtures/{ptb,an4}``, PTB's stream rows
at P = 2 rank 1 included, AN4's padding, lengths and ``truncated_count``.

Models, at a small size (PTB: vocabulary 64, hidden 16, two layers; AN4:
hidden 8, two bidirectional layers, the full 161 bins), dropout at rate 0
on both sides (flax and the port draw masks from different generators):
logits and the carry in float32 within rtol 1e-4 and atol 1e-5; the AN4
batch has rows of unequal lengths, so the backward direction's flax
semantics (valid frames reversed, then the padding reversed) and the
padded frames' share of the BatchNorm statistics are held; gradients and
the new BatchNorm statistics in float64 on both sides within 1e-7, as in
``tests/test_torch_zoo.py``. flax casts its logits to float32, so PTB's
gradients carry that rounding; AN4's are those of a fixed random linear
function of the logits, which the cast leaves exact, and the JAX AN4
model's two float32 choices (its BatchNorms, flax's zero carry) are
lifted to float64 inside that computation. The flat layout is exact.

CTC: per utterance within rtol 1e-5 of ``optax.ctc_loss``, with repeated
labels and padding; an infeasible alignment gives optax a large finite
loss and the port 0 with no gradient (``ctc.py``). The greedy decode's
counts equal the JAX trainer's ``_greedy_error_counts``.
"""

import os
import types

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from gtopkssgd_tpu import native
from gtopkssgd_tpu.data import get_dataset as jax_get_dataset
from gtopkssgd_tpu.models import get_model as jax_get_model
from gtopkssgd_tpu.models.lstm import PTBLSTM as JaxPTBLSTM
from gtopkssgd_tpu.models import lstman4 as jax_lstman4
from gtopkssgd_tpu.models.lstman4 import DeepSpeechAN4 as JaxAN4
from gtopkssgd_tpu.trainer import Trainer as JaxTrainer
from gtopkssgd_tpu_torch import ctc
from gtopkssgd_tpu_torch.convert import flat_layout, flax_path, from_jax_params
from gtopkssgd_tpu_torch.data import get_dataset
from gtopkssgd_tpu_torch.models import DeepSpeechAN4, PTBLSTM, get_model

torch.set_num_threads(2)
FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
RTOL, ATOL = 1e-4, 1e-5
TOL64 = 1e-7
CTC_RTOL = 1e-5


def _same_batches(a, b, count):
    n = 0
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for key in x:
            np.testing.assert_array_equal(x[key], y[key], err_msg=key)
        n += 1
        if n == count:
            break
    assert n == count


@pytest.mark.parametrize("split,p,rank,data_dir,bptt", [
    ("train", 1, 0, None, 35), ("train", 2, 1, None, 35),
    ("test", 1, 0, None, 35), ("valid", 2, 0, None, 35),
    ("train", 1, 0, "ptb", 5), ("valid", 1, 0, "ptb", 5),
    ("test", 1, 0, "ptb", 3)])
def test_ptb_batches_match_the_jax_pipeline(split, p, rank, data_dir, bptt):
    kw = dict(split=split, batch_size=2, rank=rank, nworkers=p, seed=5,
              bptt=bptt,
              data_dir=None if data_dir is None else os.path.join(FIX,
                                                                  data_dir))
    j, t = jax_get_dataset("ptb", **kw), get_dataset("ptb", **kw)
    assert t.synthetic == j.synthetic == (data_dir is None)
    assert t.vocab == j.vocab and t.vocab_size == j.vocab_size
    assert t.steps_per_epoch() == j.steps_per_epoch()
    assert not hasattr(t, "partitioner")
    np.testing.assert_array_equal(t.tokens, j.tokens)
    _same_batches(j.epoch(0), t.epoch(0), min(3, t.steps_per_epoch()))
    # The stream crosses epochs in the same order.
    _same_batches(iter(j), iter(t), t.steps_per_epoch() + 1)


@pytest.mark.parametrize("split,p,rank,epoch,data_dir,max_frames", [
    ("train", 1, 0, 0, None, 400), ("train", 2, 1, 1, None, 400),
    ("test", 1, 0, 0, None, 400), ("train", 1, 0, 0, None, 60),
    ("train", 1, 0, 0, "an4", 400), ("test", 1, 0, 0, "an4", 30)])
def test_an4_batches_match_the_jax_pipeline(split, p, rank, epoch, data_dir,
                                            max_frames):
    kw = dict(split=split, batch_size=2, rank=rank, nworkers=p, seed=3,
              max_frames=max_frames, max_label_len=8,
              data_dir=None if data_dir is None else os.path.join(FIX,
                                                                  data_dir))
    j, t = jax_get_dataset("an4", **kw), get_dataset("an4", **kw)
    assert t.synthetic == j.synthetic == (data_dir is None)
    assert t.steps_per_epoch() == j.steps_per_epoch()
    count = min(4, t.steps_per_epoch())
    _same_batches(j.epoch(epoch), t.epoch(epoch), count)
    assert t.truncated_count == j.truncated_count
    if max_frames < 400:
        assert t.truncated_count > 0
    batch = next(t.epoch(epoch))
    assert batch["spectrogram"].shape == (2, max_frames, 161)
    assert batch["labels"].shape == (2, 8)


def test_an4_epoch_makes_only_the_batches_asked_for():
    ds = get_dataset("an4", split="test", batch_size=4, seed=1)
    full = list(ds.epoch(0))
    assert len(full) == ds.steps_per_epoch() == 16
    some = list(ds.epoch(0, range(1, 16, 5)))
    assert len(some) == 3
    for got, want in zip(some, full[1::5]):
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])


def test_an4_text_and_spectrogram_helpers_match():
    from gtopkssgd_tpu.data import an4 as jan4
    from gtopkssgd_tpu_torch.data import an4 as tan4

    assert tan4.LABELS == jan4.LABELS and tan4.SPACE_ID == 28
    text = "Hello, World's 42 END"
    np.testing.assert_array_equal(tan4.text_to_ids(text),
                                  jan4.text_to_ids(text))
    wav = os.path.join(FIX, "an4", "hello.wav")
    np.testing.assert_array_equal(tan4.wav_to_logspec(wav),
                                  jan4.wav_to_logspec(wav))


# ---------------------------------------------------------------- models

def _perturb_stats(tree, rng):
    """BatchNorm scales and variances to 1 + 0.1 |N|, biases and means to
    0.1 N; kernels unchanged."""
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


def _to64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _port_grads64(tm64):
    lay = flat_layout(tm64)
    return lay.ravel([p.grad for p in lay.params],
                     out=torch.empty(lay.n, dtype=torch.float64)).numpy()


@pytest.fixture(scope="module")
def ptb_pair():
    """The small PTB LSTM on both sides: logits and the new carry from a
    random carry in float32, and the gradients of the mean cross-entropy
    in float64."""
    rng = np.random.default_rng(0)
    vocab, hidden = 64, 16
    tokens = rng.integers(0, vocab, (3, 7)).astype(np.int32)
    targets = rng.integers(0, vocab, (3, 7)).astype(np.int32)
    carry = tuple((rng.standard_normal((3, hidden)).astype(np.float32),
                   rng.standard_normal((3, hidden)).astype(np.float32))
                  for _ in range(2))
    jm = JaxPTBLSTM(vocab_size=vocab, hidden_size=hidden, dropout_rate=0.0)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(tokens))["params"]
    params = _perturb_stats(params, rng)  # the cells' biases off zero
    jlogits, jcarry = jm.apply({"params": params}, jnp.asarray(tokens),
                               carry)
    with jax.enable_x64(True):
        jm64 = JaxPTBLSTM(vocab_size=vocab, hidden_size=hidden,
                          dropout_rate=0.0, dtype=jnp.float64)

        def loss_fn(p):
            logits, _ = jm64.apply({"params": p}, jnp.asarray(tokens),
                                   _to64(carry))
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, jnp.asarray(targets)).mean()

        jgrads64 = np.asarray(ravel_pytree(
            jax.grad(loss_fn)(_to64(params)))[0])

    tm = PTBLSTM(vocab_size=vocab, hidden_size=hidden, dropout_rate=0.0)
    tm.load_state_dict(from_jax_params(params))
    tcarry = tuple((torch.from_numpy(c), torch.from_numpy(h))
                   for c, h in carry)
    with torch.no_grad():
        tlogits, tnew = tm(torch.from_numpy(tokens).long(), tcarry)
    tm64 = PTBLSTM(vocab_size=vocab, hidden_size=hidden,
                   dropout_rate=0.0).double()
    tm64.load_state_dict(from_jax_params(params))
    logits64, _ = tm64(torch.from_numpy(tokens).long(),
                       tuple((c.double(), h.double()) for c, h in tcarry))
    torch.nn.functional.cross_entropy(
        logits64.reshape(-1, vocab),
        torch.from_numpy(targets).long().reshape(-1)).backward()
    return dict(params=params, jm=jm, tm=tm, jlogits=np.asarray(jlogits),
                jcarry=jcarry, tlogits=tlogits.numpy(), tcarry=tnew,
                jgrads64=jgrads64, tgrads64=_port_grads64(tm64))


def test_ptb_logits_and_carry(ptb_pair):
    np.testing.assert_allclose(ptb_pair["tlogits"], ptb_pair["jlogits"],
                               rtol=RTOL, atol=ATOL)
    for (jc, jh), (tc, th) in zip(ptb_pair["jcarry"], ptb_pair["tcarry"]):
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=RTOL,
                                   atol=ATOL)


def test_ptb_gradients_in_flat_layout(ptb_pair):
    np.testing.assert_allclose(ptb_pair["tgrads64"], ptb_pair["jgrads64"],
                               rtol=TOL64, atol=TOL64)


def test_ptb_flat_layout_is_ravel_pytree(ptb_pair):
    lay = flat_layout(ptb_pair["tm"])
    want, _ = ravel_pytree(ptb_pair["params"])
    got = lay.ravel(list(lay.params))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    # ravel_pytree's order: Dense_0, Embed_0, then each cell's gates as
    # strings (hf, hg, hi, ho, if, ig, ii, io), bias before kernel.
    order = [flax_path(n) for n, _ in sorted(
        ptb_pair["tm"].named_parameters(), key=lambda i: flax_path(i[0]))]
    assert order[:4] == [("Dense_0", "bias"), ("Dense_0", "kernel"),
                         ("Embed_0", "embedding"),
                         ("OptimizedLSTMCell_0", "hf", "bias")]
    gates = [p[1] for p in order if p[0] == "OptimizedLSTMCell_1"]
    assert gates == ["hf", "hf", "hg", "hg", "hi", "hi", "ho", "ho", "if",
                     "ig", "ii", "io"]


def _an4_batch(rng, lengths, frames=48, bins=161):
    x = np.zeros((len(lengths), frames, bins), np.float32)
    for b, n in enumerate(lengths):
        x[b, :n] = rng.standard_normal((n, bins))
    return x, np.asarray(lengths, np.int32)


def _jax_ctc(logits, out_len, labels, label_lengths):
    t = logits.shape[1]
    lpad = (jnp.arange(t)[None, :] >= out_len[:, None]).astype(logits.dtype)
    ypad = (jnp.arange(labels.shape[1])[None, :]
            >= label_lengths[:, None]).astype(logits.dtype)
    return optax.ctc_loss(logits, lpad, labels, ypad)


@pytest.fixture(scope="module")
def an4_pair():
    """The small AN4 model on both sides, one batch of unequal lengths (48,
    31 and 17 frames: 12, 8 and 5 after the convs): logits and the new
    BatchNorm statistics in train mode, logits in eval mode and without
    lengths, in float32; in float64 the new statistics and the gradients
    of a fixed random linear function of the logits (the flax model
    casts its logits to float32, and optax's CTC would then run in
    float32: the CTC's own gradient is held in float64 apart, in
    ``test_ctc_loss_matches_optax_per_utterance``)."""
    rng = np.random.default_rng(2)
    x, lengths = _an4_batch(rng, [48, 31, 17])
    jm = JaxAN4(rnn_hidden=8, rnn_layers=2)
    v = jm.init(jax.random.PRNGKey(4), jnp.asarray(x), jnp.asarray(lengths))
    params = _perturb_stats(v["params"], rng)
    stats = _perturb_stats(v["batch_stats"], rng)
    variables = {"params": params, "batch_stats": stats}
    jtrain, _ = jm.apply(variables, jnp.asarray(x), jnp.asarray(lengths),
                         train=True, mutable=["batch_stats"])
    jeval = jm.apply(variables, jnp.asarray(x), jnp.asarray(lengths))
    jfull = jm.apply(variables, jnp.asarray(x))
    weight = rng.standard_normal(jtrain.shape).astype(np.float32)
    # In float64 two of the JAX model's float32 choices are lifted, for
    # this computation only: its BatchNorms compute in float32 whatever
    # the model's dtype, and flax makes the zero carry in the cell's
    # param_dtype (float32), which a float64 scan refuses.
    make_carry = flax_nn.OptimizedLSTMCell.initialize_carry

    def carry64(self, rng, input_shape):
        return jax.tree.map(lambda a: a.astype(jnp.float64),
                            make_carry(self, rng, input_shape))

    def batchnorm64(**kw):
        return flax_nn.BatchNorm(**{**kw, "dtype": jnp.float64})

    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax_nn.OptimizedLSTMCell, "initialize_carry", carry64)
        mp.setattr(jax_lstman4, "nn", types.SimpleNamespace(
            **{**vars(flax_nn), "BatchNorm": batchnorm64}))
        jm64 = JaxAN4(rnn_hidden=8, rnn_layers=2, dtype=jnp.float64)

        def loss_fn(p):
            logits, mut = jm64.apply(
                {"params": p, "batch_stats": _to64(stats)},
                jnp.asarray(x, jnp.float64), jnp.asarray(lengths),
                train=True, mutable=["batch_stats"])
            return jnp.sum(logits * jnp.asarray(weight)), mut

        (_, mut), g = jax.value_and_grad(loss_fn, has_aux=True)(
            _to64(params))
        jgrads64 = np.asarray(ravel_pytree(g)[0])
        jstats64 = jax.tree.map(np.asarray, mut["batch_stats"])

    state = from_jax_params(params, stats)
    tm = DeepSpeechAN4(rnn_hidden=8, rnn_layers=2)
    tm.load_state_dict(state)
    xt, lt = torch.from_numpy(x), torch.from_numpy(lengths)
    with torch.no_grad():  # eval first: train mode moves the statistics
        teval = tm.eval()(xt, lt)
        tfull = tm(xt)
        ttrain = tm.train()(xt, lt)
    tm64 = DeepSpeechAN4(rnn_hidden=8, rnn_layers=2).double()
    tm64.load_state_dict(state)
    tm64.train()
    (tm64(xt.double(), lt) * torch.from_numpy(weight).double()).sum(
    ).backward()
    return dict(params=params, stats=stats, state=state, x=x,
                lengths=lengths, jtrain=np.asarray(jtrain),
                jeval=np.asarray(jeval), jfull=np.asarray(jfull),
                ttrain=ttrain.numpy(), teval=teval.numpy(),
                tfull=tfull.numpy(), tm=tm, tm64=tm64, jgrads64=jgrads64,
                jstats64=jstats64, tgrads64=_port_grads64(tm64))


@pytest.mark.parametrize("mode", ["train", "eval", "full"])
def test_an4_logits(an4_pair, mode):
    got, want = an4_pair["t" + mode], an4_pair["j" + mode]
    assert got.shape == want.shape == (3, 12, 29)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_an4_padded_frames_are_not_zero_and_feed_batchnorm(an4_pair):
    """Row 2 keeps 5 of 12 frames: flax's outputs at its padded frames
    are the recurrences run over the padding, and they reach the next
    BatchNorm's statistics (the float64 statistics test holds them)."""
    got = an4_pair["ttrain"]
    assert np.abs(got[2, 5:] - got[2, 4]).max() > 1e-3
    assert np.abs(got[2, 5:]).max() > 0


def test_an4_gradients_in_flat_layout(an4_pair):
    np.testing.assert_allclose(an4_pair["tgrads64"], an4_pair["jgrads64"],
                               rtol=TOL64, atol=TOL64)


def test_an4_updated_batch_stats(an4_pair):
    buffers = dict(an4_pair["tm64"].named_buffers())
    assert len(buffers) == len(jax.tree.leaves(an4_pair["jstats64"])) == 8
    for name, buf in buffers.items():
        want = an4_pair["jstats64"]
        for key in flax_path(name):
            want = want[key]
        np.testing.assert_allclose(buf.numpy(), want, rtol=TOL64,
                                   atol=TOL64, err_msg=name)


def test_an4_flat_layout_is_ravel_pytree(an4_pair):
    lay = flat_layout(an4_pair["tm"])
    want, _ = ravel_pytree(an4_pair["params"])
    got = lay.ravel(list(lay.params))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


def test_an4_cell_order_is_read_off_flax(an4_pair):
    """Cell 2l is layer l's forward direction and 2l + 1 its backward one:
    the port's logits match flax's with that assignment and not with the
    two swapped."""
    state = dict(an4_pair["state"])
    for layer in range(2):
        for key in list(state):
            for a, b in ((2 * layer, 2 * layer + 1),
                         (2 * layer + 1, 2 * layer)):
                if key.startswith(f"cells.{a}."):
                    rest = key[len(f"cells.{a}."):]
                    state[key] = an4_pair["state"][f"cells.{b}.{rest}"]
    tm = DeepSpeechAN4(rnn_hidden=8, rnn_layers=2)
    tm.load_state_dict(state)
    tm.eval()
    with torch.no_grad():
        swapped = tm(torch.from_numpy(an4_pair["x"]),
                     torch.from_numpy(an4_pair["lengths"])).numpy()
    assert np.abs(swapped - an4_pair["jeval"]).max() > 1e-2
    np.testing.assert_allclose(an4_pair["teval"], an4_pair["jeval"],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dnn,n", [("lstm", 19_775_200),
                                   ("lstman4", 20_340_477)])
def test_full_size_param_counts_and_specs_match_flax(dnn, n):
    jm, jspec = jax_get_model(dnn)
    shape = (1,) + jspec.example_shape
    x = jax.ShapeDtypeStruct(shape, jnp.int32 if dnn == "lstm"
                             else jnp.float32)
    shapes = jax.eval_shape(lambda a: jm.init(jax.random.PRNGKey(0), a), x)
    want = sum(int(np.prod(s.shape)) for s in
               jax.tree.leaves(shapes["params"]))
    model, spec = get_model(dnn)
    assert want == flat_layout(model).n == n
    assert (spec.dataset, spec.example_shape, spec.has_batchnorm,
            spec.recurrent) == (jspec.dataset, jspec.example_shape,
                                jspec.has_batchnorm, jspec.recurrent)


def test_lstm_layer_initializers():
    """flax's OptimizedLSTMCell initializers: LeCun-normal input kernels
    (truncated at 2 std), orthogonal hidden kernels, zero biases."""
    model, _ = get_model("lstm")
    model.reset_parameters(torch.Generator().manual_seed(0))
    cell = model.cells[0]
    hh = cell.kernel["hf"]
    torch.testing.assert_close(hh @ hh.T, torch.eye(650), atol=1e-4,
                               rtol=0)
    ii = cell.kernel["ii"]
    assert abs(float(ii.std()) - (1 / 650) ** 0.5) < 2e-3
    assert float(ii.abs().max()) <= 2 * (1 / 650) ** 0.5 / 0.8796 + 1e-6
    assert all(float(b.abs().max()) == 0.0 for b in cell.bias.values())
    assert abs(float(model.embed.weight.std()) - (1 / 650) ** 0.5) < 2e-3


# ------------------------------------------------------------------- CTC

def test_ctc_loss_matches_optax_per_utterance():
    rng = np.random.default_rng(7)
    b, t, c = 5, 20, 29
    logits = rng.standard_normal((b, t, c)).astype(np.float32) * 2
    out_len = np.array([20, 14, 9, 6, 20], np.int32)
    labels = np.zeros((b, 8), np.int32)
    rows = [[3, 3, 5, 5, 5], [7, 7, 7], [1, 2, 3, 4], [28, 28], [9]]
    for i, r in enumerate(rows):
        labels[i, :len(r)] = r
    lab_len = np.array([len(r) for r in rows], np.int32)
    want = np.asarray(_jax_ctc(jnp.asarray(logits), jnp.asarray(out_len),
                               jnp.asarray(labels), jnp.asarray(lab_len)))
    lt = torch.from_numpy(logits)
    per_utt = torch.nn.functional.ctc_loss(
        lt.log_softmax(-1).transpose(0, 1), torch.from_numpy(labels).long(),
        torch.from_numpy(out_len).long(), torch.from_numpy(lab_len).long(),
        blank=0, reduction="none")
    np.testing.assert_allclose(per_utt.numpy(), want, rtol=CTC_RTOL)
    mean = ctc.ctc_loss(lt, torch.from_numpy(out_len),
                        torch.from_numpy(labels), torch.from_numpy(lab_len))
    np.testing.assert_allclose(float(mean), float(want.mean()),
                               rtol=CTC_RTOL)
    # The gradient of the mean with respect to the logits, in float64.
    with jax.enable_x64(True):
        jgrad = np.asarray(jax.grad(lambda z: _jax_ctc(
            z, jnp.asarray(out_len), jnp.asarray(labels),
            jnp.asarray(lab_len)).mean())(jnp.asarray(logits, jnp.float64)))
    l64 = torch.from_numpy(logits).double().requires_grad_()
    ctc.ctc_loss(l64, torch.from_numpy(out_len), torch.from_numpy(labels),
                 torch.from_numpy(lab_len)).backward()
    np.testing.assert_allclose(l64.grad.numpy(), jgrad, rtol=TOL64,
                               atol=TOL64)


def test_ctc_infeasible_alignment_counts_zero():
    """Four frames cannot hold the labels 1 1 1 (three labels and two
    repeats need five): optax gives a large finite loss, the port 0 and
    no gradient for that utterance; the other utterance is unaffected."""
    rng = np.random.default_rng(8)
    logits = rng.standard_normal((2, 6, 29)).astype(np.float32)
    out_len = np.array([4, 6], np.int32)
    labels = np.array([[1, 1, 1], [4, 5, 0]], np.int32)
    lab_len = np.array([3, 2], np.int32)
    want = np.asarray(_jax_ctc(jnp.asarray(logits), jnp.asarray(out_len),
                               jnp.asarray(labels), jnp.asarray(lab_len)))
    assert np.isfinite(want[0]) and want[0] > 1e3
    lt = torch.from_numpy(logits).requires_grad_()
    loss = ctc.ctc_loss(lt, torch.from_numpy(out_len),
                        torch.from_numpy(labels), torch.from_numpy(lab_len))
    loss.backward()
    np.testing.assert_allclose(float(loss), want[1] / 2, rtol=CTC_RTOL)
    assert float(lt.grad[0].abs().max()) == 0.0
    assert torch.isfinite(lt.grad).all() and float(lt.grad[1].abs().max()) > 0


def test_greedy_error_counts_match_the_jax_trainer():
    rng = np.random.default_rng(11)
    b, t = 6, 30
    # Frames mostly blank or space, with runs, so repeats collapse and
    # words split.
    pred = rng.choice([0, 0, 0, 28, 3, 4, 5, 5, 6], size=(b, t))
    pred = np.repeat(pred[:, ::2], 2, axis=1)
    logits = rng.standard_normal((b, t, 29)).astype(np.float32)
    logits[np.arange(b)[:, None], np.arange(t)[None, :], pred] += 10.0
    lengths = np.array([120, 100, 57, 9, 1, 120], np.int32)
    labels = rng.choice([28, 3, 4, 5, 6, 7], size=(b, 12)).astype(np.int32)
    lab_len = np.array([12, 5, 0, 3, 1, 7], np.int32)
    batch = {"input_lengths": lengths, "labels": labels,
             "label_lengths": lab_len}
    stub = types.SimpleNamespace(model=JaxAN4, _AN4_SPACE_ID=28)
    want = JaxTrainer._greedy_error_counts(stub, batch, jnp.asarray(logits))
    got = ctc.greedy_error_counts(logits, DeepSpeechAN4.output_length(
        lengths), labels, lab_len)
    np.testing.assert_array_equal(got, want)
    assert got[0] > 0 and got[2] > 0


def test_edit_distance_matches_the_jax_package():
    rng = np.random.default_rng(12)
    for _ in range(50):
        a = rng.integers(0, 4, rng.integers(0, 9)).tolist()
        b = rng.integers(0, 4, rng.integers(0, 9)).tolist()
        assert ctc.edit_distance(a, b) == native.edit_distance(a, b)
