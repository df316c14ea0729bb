"""The port's vision zoo against the JAX package's flax models, with the
weights carried by ``convert.from_jax_params``; the port's dropout; the
synthetic ImageNet pipeline against the JAX one.

Each pair is built at a small size from one numpy seed: VGG-16 at batch
4; AlexNet at 64x64 with 10 classes; ResNet-50's bottleneck design with
one block a stage and 10 classes at 64x64, with and without the
space-to-depth stem. flax's initial parameters are moved from the seed
(BatchNorm scales 1 + 0.1 |N|, every bias and running statistic), so no
branch is zeroed out: the bottleneck's last BatchNorm starts at scale 0,
which would leave its three convs without a gradient. Dropout is built
at rate 0 on both sides (flax and the port draw their masks from
different generators).

In float32, on the CPU, the two sum convolutions and reductions in
different orders, and flax's BatchNorm takes the variance as E[x^2] -
E[x]^2 where the port's (cuDNN's on the card) subtracts the mean first.
Logits in train mode are held within 1e-4, absolute and relative (the
largest error measured: 2.5e-5 for VGG-16, whose last BatchNorms
normalize over 4 and 16 values, 1.3e-5 for the ResNets, 7.5e-7 for
AlexNet), eval logits within 1e-5 and the loss within 1e-5 relative
(1.2e-6 measured, VGG-16).
Gradients are not held in float32: a ReLU input that rounds to the other
side of 0 in one framework moves its whole upstream gradient (measured:
up to 0.015 at one element of block 1 of the small ResNet-50, against
1e-5 elsewhere), so gradients and the new BatchNorm statistics are held
in float64 on both sides (flax built with ``dtype=float64`` under
``jax.enable_x64``, the port's model in double) within 1e-7: the flax
models still cast their logits to float32, whose rounding reaches the
gradients (1.8e-8 absolute at most, measured on AlexNet). The weight
carry and the flat layout (``ravel_pytree``'s order, string-sorted
module names: ``BatchNorm_10`` before ``BatchNorm_2``) are exact.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from jax.flatten_util import ravel_pytree

from gtopkssgd_tpu.data.imagenet import ImageNetDataset as JaxImageNet
from gtopkssgd_tpu.models import get_model as jax_get_model
from gtopkssgd_tpu.models.alexnet import AlexNet as JaxAlexNet
from gtopkssgd_tpu.models.resnet import ResNetImageNet as JaxResNet
from gtopkssgd_tpu.models.vgg import VGG16 as JaxVGG
from gtopkssgd_tpu_torch.convert import flat_layout, flax_path, from_jax_params
from gtopkssgd_tpu_torch.data import get_dataset
from gtopkssgd_tpu_torch.models import (
    AlexNet,
    Dropout,
    ResNetImageNet,
    VGG16,
    get_model,
    seed_dropout,
)

torch.set_num_threads(2)
TOL = 1e-5
LOGIT_TOL = 1e-4
TOL64 = 1e-7

SMALL = (1, 1, 1, 1)
# name: (flax model of a dtype, port model, input shape NHWC)
CASES = {
    "vgg16": (lambda dt: JaxVGG(dropout_rate=0.0, dtype=dt),
              lambda: VGG16(dropout_rate=0.0), (4, 32, 32, 3)),
    "alexnet": (lambda dt: JaxAlexNet(num_classes=10, dropout_rate=0.0,
                                      dtype=dt),
                lambda: AlexNet(num_classes=10, dropout_rate=0.0,
                                image_size=64), (4, 64, 64, 3)),
    "resnet50": (lambda dt: JaxResNet(stage_sizes=SMALL, num_classes=10,
                                      dtype=dt),
                 lambda: ResNetImageNet(stage_sizes=SMALL, num_classes=10),
                 (2, 64, 64, 3)),
    "resnet50-s2d": (
        lambda dt: JaxResNet(stage_sizes=SMALL, num_classes=10, dtype=dt,
                             space_to_depth=True),
        lambda: ResNetImageNet(stage_sizes=SMALL, num_classes=10,
                               space_to_depth=True), (2, 64, 64, 3)),
}


def _perturb(tree, rng):
    """Move every leaf off flax's initial value: scales and variances to
    1 + 0.1 |N|, biases and means to 0.1 N, kernels unchanged."""
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


def _jax_step(jm, params, stats, x, y):
    """flax in train mode: (loss, logits, new batch stats, grads)."""
    def loss_fn(p):
        logits, mut = jm.apply({"params": p, "batch_stats": stats}, x,
                               train=True, mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()
        return loss, (logits, mut.get("batch_stats", {}))

    (loss, (logits, new_stats)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    return loss, logits, new_stats, grads


def _port_step(tm, x, y):
    """The port in train mode: (loss, logits); the gradients stay in
    ``.grad``."""
    tm.train()
    logits = tm(x)
    loss = F.cross_entropy(logits, y)
    loss.backward()
    return loss.detach(), logits.detach()


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    """One model on both sides with the same weights; one batch through
    each in train mode and in eval mode in float32, and in train mode in
    float64."""
    make_jax, make_port, shape = CASES[request.param]
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    y = rng.integers(0, 10, shape[0]).astype(np.int32)
    jm = make_jax(jnp.float32)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    params = _perturb(variables["params"], rng)
    stats = _perturb(variables.get("batch_stats", {}), rng)
    jloss, jlogits, _, _ = _jax_step(jm, params, stats, jnp.asarray(x),
                                     jnp.asarray(y))
    jeval = jm.apply({"params": params, "batch_stats": stats},
                     jnp.asarray(x), train=False)
    with jax.enable_x64(True):
        to64 = lambda t: jax.tree.map(  # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64), t)
        _, _, jstats64, jgrads64 = _jax_step(
            make_jax(jnp.float64), to64(params), to64(stats),
            jnp.asarray(x, jnp.float64), jnp.asarray(y))
        jgrads64 = np.asarray(ravel_pytree(jgrads64)[0])
        jstats64 = jax.tree.map(np.asarray, jstats64)

    state = from_jax_params(params, stats)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    tm = make_port()
    tm.load_state_dict(state)
    tm.eval()
    with torch.no_grad():
        teval = tm(xt)
    tloss, tlogits = _port_step(tm, xt, yt)
    tm64 = make_port().double()
    tm64.load_state_dict(state)
    _port_step(tm64, xt.double(), yt)
    lay = flat_layout(tm64)
    tgrads64 = lay.ravel([p.grad for p in lay.params],
                         out=torch.empty(lay.n, dtype=torch.float64))
    return dict(name=request.param, params=params, jloss=jloss,
                jlogits=jlogits, jeval=jeval, jgrads64=jgrads64,
                jstats64=jstats64, tm=tm, tloss=tloss, tlogits=tlogits,
                teval=teval, tm64=tm64, tgrads64=tgrads64.numpy())


def test_weight_carry_and_flat_layout_are_exact(pair):
    tm = pair["tm"]
    lay = flat_layout(tm)
    want, _ = ravel_pytree(pair["params"])
    got = lay.ravel(list(lay.params))
    assert lay.n == want.shape[0]
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


def test_train_mode_logits_and_loss(pair):
    np.testing.assert_allclose(pair["tlogits"].numpy(),
                               np.asarray(pair["jlogits"]),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_allclose(float(pair["tloss"]), float(pair["jloss"]),
                               rtol=TOL)


def test_eval_mode_logits(pair):
    np.testing.assert_allclose(pair["teval"].numpy(),
                               np.asarray(pair["jeval"]),
                               rtol=TOL, atol=TOL)


def test_gradients_in_flat_layout(pair):
    """In float64 (see the module docstring)."""
    np.testing.assert_allclose(pair["tgrads64"], pair["jgrads64"],
                               rtol=TOL64, atol=TOL64)


def test_updated_batch_stats(pair):
    """In float64 (see the module docstring)."""
    buffers = dict(pair["tm64"].named_buffers())
    assert bool(buffers) == (pair["name"] != "alexnet")
    assert len(buffers) == len(jax.tree.leaves(pair["jstats64"]))
    for name, buf in buffers.items():
        want = pair["jstats64"]
        for key in flax_path(name):
            want = want[key]
        np.testing.assert_allclose(buf.numpy(), want, rtol=TOL64,
                                   atol=TOL64, err_msg=name)


def test_flat_order_sorts_module_names_as_strings():
    """``ravel_pytree`` sorts flax's names as strings: the 13 VGG
    BatchNorms run 0, 1, 10, 11, 12, 2, ... and ResNet-50's 16 blocks
    likewise."""
    order = [flax_path(n) for n, _ in sorted(
        VGG16().named_parameters(), key=lambda it: flax_path(it[0]))]
    bns = [p[0] for p in order if p[0].startswith("BatchNorm")][::2]
    assert bns[:4] == ["BatchNorm_0", "BatchNorm_1", "BatchNorm_10",
                       "BatchNorm_11"]
    assert order[-1] == ("Dense_1", "kernel")
    names = dict(ResNetImageNet().named_parameters())
    assert flax_path("bottlenecks.10.shortcut.1.weight") == (
        "BottleneckBlock_10", "BatchNorm_3", "scale")
    assert "bottlenecks.15.bn3.weight" in names
    assert flax_path("convs.4.bias") == ("Conv_4", "bias")


@pytest.mark.parametrize("dnn,kwargs,want", [
    ("vgg16", {}, 14_986_698),
    ("resnet50", {}, 25_557_032),
    ("alexnet", {}, 61_100_840),
])
def test_full_size_param_counts_match_flax(dnn, kwargs, want):
    """At full size only the counts: the flax side through
    ``jax.eval_shape`` (no arrays), the port's flat layout."""
    spec_model, spec = jax_get_model(dnn, **kwargs)
    x = jax.ShapeDtypeStruct((1,) + spec.example_shape, jnp.float32)
    shapes = jax.eval_shape(
        lambda a: spec_model.init(jax.random.PRNGKey(0), a), x)
    n = sum(int(np.prod(s.shape)) for s in
            jax.tree.leaves(shapes["params"]))
    model, pspec = get_model(dnn, **kwargs)
    assert n == flat_layout(model).n == want
    assert pspec.dataset == spec.dataset
    assert pspec.example_shape == spec.example_shape
    assert pspec.has_batchnorm == spec.has_batchnorm


def test_space_to_depth_is_resnet50_only_with_the_jax_error():
    model, _ = get_model("resnet50", space_to_depth=True)
    assert model.conv.weight.shape == (64, 12, 4, 4)
    get_model("vgg16", space_to_depth=False)  # false: accepted everywhere
    for dnn in ("vgg16", "alexnet", "resnet20"):
        with pytest.raises(ValueError) as want:
            jax_get_model(dnn, space_to_depth=True)
        with pytest.raises(ValueError) as got:
            get_model(dnn, space_to_depth=True)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="even input"):
        ResNetImageNet(stage_sizes=SMALL, space_to_depth=True)(
            torch.zeros(1, 63, 64, 3))


def test_dropout_keeps_half_scales_by_two_and_is_seeded():
    drop = Dropout(0.5)
    seed_dropout(torch.nn.Sequential(torch.nn.Linear(1, 1), drop), 7)
    x = torch.ones(100_000)
    a = drop(x)
    kept = a != 0
    assert abs(float(kept.float().mean()) - 0.5) <= 0.02
    assert torch.all(a[kept] == 2.0)
    b = drop(x)
    assert not torch.equal(a, b)  # the generator advances
    other = Dropout(0.5)
    seed_dropout(torch.nn.Sequential(torch.nn.Linear(1, 1), other), 7)
    assert torch.equal(other(x), a)  # the same seed, the same mask
    drop.eval()
    assert drop(x) is x
    drop.train()
    assert Dropout(0.0)(x) is x
    with pytest.raises(RuntimeError, match="seed_dropout"):
        Dropout(0.5)(x)


def test_dropout_is_on_in_train_mode_of_the_zoo():
    model = AlexNet(num_classes=10, image_size=64)
    model.reset_parameters(torch.Generator().manual_seed(0))
    seed_dropout(model, 3)
    x = torch.randn(2, 64, 64, 3)
    assert not torch.equal(model(x), model(x))
    model.eval()
    assert torch.equal(model(x), model(x))


@pytest.mark.parametrize("p,rank,split,epoch", [
    (1, 0, "train", 0), (1, 0, "train", 1), (1, 0, "test", 0),
    (3, 2, "train", 0), (3, 1, "train", 1), (3, 0, "test", 1),
])
def test_imagenet_batches_match_the_jax_pipeline(p, rank, split, epoch):
    """The port's synthetic ImageNet draws the JAX pipeline's batches
    (labels, class offsets, per-index images, shard order), bit for
    bit."""
    kw = dict(split=split, batch_size=4, rank=rank, nworkers=p, seed=5)
    jd, td = JaxImageNet(**kw), get_dataset("imagenet", **kw)
    assert td.steps_per_epoch() == jd.steps_per_epoch()
    jb, tb = jd.epoch(epoch), td.epoch(epoch)
    for _ in range(2):
        a, b = next(jb), next(tb)
        assert b["image"].dtype == np.uint8 and b["image"].shape == (
            4, 224, 224, 3)
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["label"], b["label"])


@pytest.mark.parametrize("dataset,split", [
    ("imagenet", "train"), ("imagenet", "test"), ("cifar10", "train"),
    ("cifar10", "test"),
])
def test_epoch_makes_only_the_batches_asked_for(dataset, split):
    """``epoch(e, batches)`` yields the full epoch's batches of those
    numbers (augmentation draws included), and ImageNet synthesizes no
    other batch."""
    kw = dict(split=split, batch_size=4, rank=1, nworkers=2, seed=5)
    full = list(itertools.islice(get_dataset(dataset, **kw).epoch(1), 8))
    data = get_dataset(dataset, **kw)
    made = []
    if dataset == "imagenet":
        synth = data._synth_batch
        data._synth_batch = lambda sel: made.append(1) or synth(sel)
    mine = range(1, 8, 3)
    got = list(data.epoch(1, mine))
    assert len(got) == len(mine)
    for b, batch in zip(mine, got):
        np.testing.assert_array_equal(batch["image"], full[b]["image"])
        np.testing.assert_array_equal(batch["label"], full[b]["label"])
    assert len(made) == (len(mine) if dataset == "imagenet" else 0)


def test_imagenet_folder_is_refused(tmp_path):
    """A split folder is read as JPEGs, never replaced by synthetic data:
    an empty ``val/`` is refused (too few samples for a batch, the JAX
    dataset's error); the train split, with no ``train/``, is synthetic."""
    (tmp_path / "val").mkdir()
    assert get_dataset("imagenet", split="train",
                       data_dir=str(tmp_path)).synthetic
    with pytest.raises(ValueError, match="samples"):
        get_dataset("imagenet", split="test", data_dir=str(tmp_path))
