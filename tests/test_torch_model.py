"""The port's ResNet against the JAX package's flax ResNet, with the weights
carried over by convert.from_jax_params.

Both compute in float32 on the CPU, with convolutions and reductions summed
in different orders: logits, gradients and batch statistics are held
within 1e-5 (absolute and relative), the loss within 1e-6 relative. The
weight carry and the flat layout are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from jax.flatten_util import ravel_pytree

from gtopkssgd_tpu.models.resnet import ResNetCIFAR as JaxResNet
from gtopkssgd_tpu_torch.convert import flat_layout, flax_path, from_jax_params
from gtopkssgd_tpu_torch.models import ResNetCIFAR, get_model

torch.set_num_threads(2)
TOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    """A depth-8 ResNet on both sides with the same weights, and one batch
    through each in train mode."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, 8).astype(np.int32)
    jm = JaxResNet(depth=8)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    params, stats = variables["params"], variables["batch_stats"]

    def loss_fn(p):
        logits, mut = jm.apply({"params": p, "batch_stats": stats},
                               jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()
        return loss, (logits, mut["batch_stats"])

    (jloss, (jlogits, jstats)), jgrads = jax.value_and_grad(
        loss_fn, has_aux=True)(params)

    tm = ResNetCIFAR(depth=8)
    tm.load_state_dict(from_jax_params(params, stats))
    tm.train()
    tlogits = tm(torch.from_numpy(x))
    tloss = F.cross_entropy(tlogits, torch.from_numpy(y).long())
    tloss.backward()
    return dict(params=params, jloss=jloss, jlogits=jlogits, jstats=jstats,
                jgrads=jgrads, tm=tm, tloss=tloss, tlogits=tlogits)


def test_weight_carry_and_flat_layout_are_exact(pair):
    tm = pair["tm"]
    lay = flat_layout(tm)
    want, _ = ravel_pytree(pair["params"])
    got = lay.ravel(list(lay.params))
    assert lay.n == want.shape[0]
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    order = [flax_path(n) for n, _ in sorted(
        tm.named_parameters(), key=lambda it: flax_path(it[0]))]
    assert order[0] == ("BasicBlock_0", "BatchNorm_0", "bias")
    assert order[-1] == ("Dense_0", "kernel")


def test_train_mode_logits_and_loss(pair):
    np.testing.assert_allclose(pair["tlogits"].detach().numpy(),
                               np.asarray(pair["jlogits"]),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(pair["tloss"].detach()),
                               float(pair["jloss"]), rtol=1e-6)


def test_gradients_in_flat_layout(pair):
    tm = pair["tm"]
    lay = flat_layout(tm)
    got = lay.ravel([p.grad for p in lay.params]).numpy()
    want, _ = ravel_pytree(pair["jgrads"])
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)


def test_updated_batch_stats(pair):
    tm = pair["tm"]
    want = from_jax_params({}, pair["jstats"])
    buffers = dict(tm.named_buffers())
    assert set(want) == set(buffers)
    for name, value in want.items():
        np.testing.assert_allclose(buffers[name].numpy(), value.numpy(),
                                   rtol=TOL, atol=TOL, err_msg=name)


def test_resnet20_param_count_and_zoo():
    model, spec = get_model("resnet20")
    assert sum(p.numel() for p in model.parameters()) == 272_474
    assert spec.dataset == "cifar10" and spec.example_shape == (32, 32, 3)
    assert flat_layout(model).n == 272_474
    model56, _ = get_model("resnet56")
    assert sum(p.numel() for p in model56.parameters()) == 855_770
    with pytest.raises(ValueError, match="unknown dnn"):
        get_model("lstm")


def test_eval_mode_uses_running_stats():
    model = ResNetCIFAR(depth=8)
    model.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(4, 32, 32, 3)
    model.eval()
    before = [b.clone() for b in model.buffers()]
    out1, out2 = model(x), model(x[:2])
    assert torch.allclose(out1[:2], out2, atol=1e-6)  # no batch coupling
    assert all(torch.equal(a, b) for a, b in zip(before, model.buffers()))
