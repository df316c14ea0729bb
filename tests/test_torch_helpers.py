"""The port's public helpers against the JAX package's: the zoo and dataset
listers (``models.available_models``, ``data.available_datasets``) and the
communicated k (``optimizer.wire_k``, ``optimizer.effective_density``),
held equal on every case, with the ValueError of a layer-wise call
without leaf sizes; and the harness's ``k_total`` under
``gtopk_layerwise`` (concat) equal to ``wire_k`` on the model's leaves.

Leaf sizes are the port's models' in flat order (built on the meta
device); their sums are the zoo's N.
"""

import pytest

from gtopkssgd_tpu.data import available_datasets as jax_datasets
from gtopkssgd_tpu.models import available_models as jax_models
from gtopkssgd_tpu.optimizer import effective_density as jax_density
from gtopkssgd_tpu.optimizer import wire_k as jax_wire_k
from gtopkssgd_tpu_torch import benchmark
from gtopkssgd_tpu_torch.data import PORT_ONLY as PORT_DATASETS
from gtopkssgd_tpu_torch.data import available_datasets, get_dataset
from gtopkssgd_tpu_torch.models import PORT_ONLY as PORT_MODELS
from gtopkssgd_tpu_torch.models import available_models, get_model
from gtopkssgd_tpu_torch.optimizer import effective_density, wire_k
from gtopkssgd_tpu_torch.select_probe import layout_sizes

N = {"resnet20": 272_474, "resnet50": 25_557_032}


def test_model_registry_lists_the_jax_zoo():
    """The JAX zoo, and the language models only the port has."""
    assert available_models() == sorted(jax_models() + list(PORT_MODELS))
    assert not set(PORT_MODELS) & set(jax_models())
    assert {"vgg16", "resnet20", "resnet50", "alexnet", "lstm",
            "lstman4"} <= set(available_models())
    with pytest.raises(ValueError):
        get_model("not-a-model")


def test_dataset_registry_lists_the_jax_datasets():
    """The JAX datasets, and the token sequences only the port has."""
    assert available_datasets() == sorted(jax_datasets()
                                          + list(PORT_DATASETS))
    assert not set(PORT_DATASETS) & set(jax_datasets())
    assert {"cifar10", "imagenet", "ptb", "an4"} <= set(available_datasets())
    with pytest.raises(ValueError):
        get_dataset("mnist")


@pytest.mark.parametrize("mode,density,dnn,leaves", [
    ("dense", 1.0, "resnet20", False),
    ("dense", 0.001, "resnet50", True),
    (None, 0.01, "resnet20", False),
    ("gtopk", 0.001, "resnet20", False),
    ("gtopk", 0.01, "resnet50", False),
    ("gtopk", 0.001, "resnet50", True),
    ("gtopk_hier", 0.01, "resnet20", False),
    ("gtopk_hier", 0.001, "resnet50", False),
    ("allgather", 0.01, "resnet20", False),
    ("allgather", 0.001, "resnet50", False),
    ("gtopk_layerwise", 0.001, "resnet20", True),
    ("gtopk_layerwise", 0.01, "resnet20", True),
    ("gtopk_layerwise", 0.001, "resnet50", True),
    ("gtopk_layerwise", 0.01, "resnet50", True),
    ("gtopk_layerwise", 0.001, "resnet20", False),
])
def test_wire_k_and_effective_density_match_jax(mode, density, dnn, leaves):
    sizes = layout_sizes(dnn)
    n = sum(sizes)
    assert n == N[dnn]
    kw = {"leaf_sizes": sizes} if leaves else {}
    if mode == "gtopk_layerwise" and not leaves:
        for fn in (wire_k, jax_wire_k):
            with pytest.raises(ValueError, match="leaf_sizes"):
                fn(mode, density, n)
        for fn in (effective_density, jax_density):
            with pytest.raises(ValueError, match="leaf_sizes"):
                fn(mode, density)
        return
    got_k = wire_k(mode, density, n, **kw)
    assert got_k == jax_wire_k(mode, density, n, **kw)
    got_d = effective_density(mode, density, **kw)
    assert got_d == jax_density(mode, density, **kw)
    if mode == "gtopk_layerwise":  # the per-leaf ceil lifts k above rho*N
        assert got_k > wire_k("gtopk", density, n)
        assert got_d == got_k / n


def test_layerwise_breakdown_k_total_is_wire_k():
    """``measure_breakdown``'s ``k_total`` on ResNet-20 under
    ``gtopk_layerwise`` with the concat wire: the per-leaf sum."""
    cfg = benchmark.BenchConfig(dnn="resnet20", batch_size=2, steps=1,
                                dtype="float32", topk_method="exact",
                                nworkers=1, device="cpu")
    rec = benchmark.measure_breakdown(cfg, "gtopk_layerwise", 0.001)
    sizes = layout_sizes("resnet20")
    assert rec["n"] == N["resnet20"]
    assert rec["k_total"] == wire_k("gtopk_layerwise", 0.001, rec["n"],
                                    sizes)
    assert rec["k_total"] > wire_k("gtopk", 0.001, rec["n"])
