"""The paper's experiment grid as a registry of runnable configs, the
port's own copy of the root ``experiments`` package's registry (the same
15 names, kwargs, descriptions and BASELINE.json mappings; the port
imports nothing of that package).

Each entry reproduces one of the paper's workload configurations
(arXiv:1901.04359; batch sizes and epochs as reconstructed in SURVEY.md).
Names follow ``<dataset>_<dnn>_<mode>``; every entry maps to a
BASELINE.json config. The descriptions are the JAX package's, word for
word: the measurements they cite were taken by that package, not on a
card.

Run one:   python -m gtopkssgd_tpu_torch.experiments.run \\
               cifar10_resnet20_gtopk
List all:  python -m gtopkssgd_tpu_torch.experiments.run --list
CI-scale:  python -m gtopkssgd_tpu_torch.experiments.run <name> \\
               --num-iters 30 --nworkers 2 --device cpu
"""

from __future__ import annotations

from typing import Any, Dict

# kwargs are TrainConfig fields; "nworkers" here is the paper's worker
# count (overridable: --nworkers 1 runs an entry on one card).
EXPERIMENTS: Dict[str, Dict[str, Any]] = {
    # --- BASELINE.json config #1: single-worker reference ---------------
    "cifar10_vgg16_single": dict(
        dnn="vgg16", batch_size=128, nworkers=1, compression=None,
        density=0.001, max_epochs=140,
        _desc="VGG-16/CIFAR-10 single worker, plain SGD (PR1 ref config)",
        _baseline="#1",
    ),
    # --- paper grid, CIFAR-10 ------------------------------------------
    "cifar10_vgg16_gtopk": dict(
        dnn="vgg16", batch_size=128, nworkers=4, compression="gtopk",
        density=0.001, max_epochs=140,
        _desc="VGG-16/CIFAR-10, 4-worker gTop-k rho=0.001",
        _baseline="#1/#2 family",
    ),
    "cifar10_resnet20_gtopk": dict(
        dnn="resnet20", batch_size=128, nworkers=4, compression="gtopk",
        density=0.001, max_epochs=140,
        _desc="ResNet-20/CIFAR-10, 4-worker gTop-k rho=0.001",
        _baseline="#2",
    ),
    "cifar10_resnet20_gtopk_warmup": dict(
        dnn="resnet20", batch_size=128, nworkers=4, compression="gtopk",
        density=0.001, max_epochs=140, warmup_epochs=4,
        dense_warmup_epochs=4,
        _desc="ResNet-20/CIFAR-10, 4-worker gTop-k with the warm-up "
              "trick (epochs 0-3: LR ramps up AND communication stays "
              "dense, concurrently; top-k starts at epoch 4 — removes "
              "the sparse cold-start ramp)",
        _baseline="#2 warm-up variant",
    ),
    "cifar10_resnet20_dense": dict(
        dnn="resnet20", batch_size=128, nworkers=4, compression="dense",
        density=1.0, max_epochs=140,
        _desc="ResNet-20/CIFAR-10, 4-worker dense-psum baseline",
        _baseline="#2 baseline",
    ),
    "cifar10_resnet20_allgather": dict(
        dnn="resnet20", batch_size=128, nworkers=4, compression="allgather",
        density=0.001, max_epochs=140,
        _desc="ResNet-20/CIFAR-10, 4-worker Top-k allgather (DGC baseline)",
        _baseline="#2 topk-baseline",
    ),
    # --- paper grid, ImageNet ------------------------------------------
    "imagenet_resnet50_gtopk": dict(
        dnn="resnet50", batch_size=32, nworkers=16, compression="gtopk",
        density=0.001, max_epochs=90, dtype="bfloat16",
        _desc="ResNet-50/ImageNet, 16-worker gTop-k rho=0.001 "
              "(north-star workload)",
        _baseline="#3",
    ),
    "imagenet_resnet50_dense": dict(
        dnn="resnet50", batch_size=32, nworkers=16, compression="dense",
        density=1.0, max_epochs=90, dtype="bfloat16",
        _desc="ResNet-50/ImageNet, 16-worker dense-psum baseline",
        _baseline="#3 baseline",
    ),
    "imagenet_alexnet_gtopk": dict(
        dnn="alexnet", batch_size=64, nworkers=16, compression="gtopk",
        density=0.001, max_epochs=95, dtype="bfloat16",
        _desc="AlexNet/ImageNet, 16-worker gTop-k rho=0.001",
        _baseline="#3",
    ),
    # --- paper grid, language/speech -----------------------------------
    "ptb_lstm_gtopk": dict(
        dnn="lstm", batch_size=20, nworkers=4, compression="gtopk",
        density=0.001, max_epochs=40,
        _desc="2-layer LSTM/PTB, 4-worker gTop-k (non-conv flat-gradient "
              "stress; clip-before-compress path)",
        _baseline="#4",
    ),
    "an4_lstm_gtopk": dict(
        dnn="lstman4", batch_size=8, nworkers=4, compression="gtopk",
        density=0.001, max_epochs=100,
        _desc="BiLSTM-CTC/AN4, 4-worker gTop-k rho=0.001",
        _baseline="paper workload 6",
    ),
    # --- extension (NOT reference parity): hierarchical two-level -------
    # Dense sum inside each slice of 4 ranks, gTop-k across slices
    # (SURVEY.md section 5).
    "imagenet_resnet50_gtopk_hier": dict(
        dnn="resnet50", batch_size=32, nworkers=16, compression="gtopk_hier",
        hier_ici=4, density=0.001, max_epochs=90, dtype="bfloat16",
        _desc="ResNet-50/ImageNet, 16 workers as 4 ICI slices x 4: dense "
              "within slice, gTop-k across (TPU extension)",
        _baseline="extension",
    ),
    # --- extension (NOT reference parity): layer-wise selection ---------
    # Per-layer top-k_l + per-layer error feedback (arXiv:1911.08772
    # lineage); the flat [N] gradient never materializes, un-serializing
    # the selection from the backward epilogues. Same gTop-k hypercube on
    # the wire.
    "imagenet_resnet50_gtopk_layerwise": dict(
        dnn="resnet50", batch_size=32, nworkers=16,
        compression="gtopk_layerwise", density=0.001, max_epochs=90,
        dtype="bfloat16",
        _desc="ResNet-50/ImageNet, 16-worker layer-wise gTop-k rho=0.001 "
              "(TPU extension)",
        _baseline="extension",
    ),
    "cifar10_resnet20_gtopk_layerwise": dict(
        dnn="resnet20", batch_size=128, nworkers=4,
        compression="gtopk_layerwise", density=0.001, max_epochs=140,
        _desc="ResNet-20/CIFAR-10, 4-worker layer-wise gTop-k rho=0.001 "
              "(TPU extension; measured 2.2x lower cold-start loss than "
              "flat gtopk — convergence_resnet20_layerwise artifact)",
        _baseline="extension",
    ),
    # --- the recommended configuration ----------------------------------
    # Chosen by the JAX package's 1200-step, identical-seed, three-arm
    # head-to-head on its CPU mesh (benchmarks/results/
    # convergence_resnet20_recommended1200_cpu_mesh2.jsonl): flat gTop-k
    # with DGC momentum correction, no warm-up phase. This is the config
    # the README tells a reference user to run.
    "cifar10_resnet20_gtopk_recommended": dict(
        dnn="resnet20", batch_size=128, nworkers=4, compression="gtopk",
        momentum_correction=True, density=0.001, max_epochs=140,
        _desc="RECOMMENDED: ResNet-20/CIFAR-10, 4-worker gTop-k "
              "rho=0.001 + DGC momentum correction — dense-parity "
              "val accuracy at the measured 1200-step horizon, no "
              "warm-up phase needed",
        _baseline="#2 recommended variant",
    ),
}

# BASELINE.json config #5 (density sweep) is a benchmark, not a training
# run: the runner runs the port's harness (gtopkssgd_tpu_torch.benchmark)
# once a density.
SWEEP_NAME = "resnet50_density_sweep"
