"""gTop-k S-SGD in PyTorch and CUDA, for NVIDIA Hopper (H100).

The port of ``gtopkssgd_tpu`` (JAX on a TPU), which stays beside it as the
reference. It imports torch, numpy and the standard library only -- never
jax, never ``gtopkssgd_tpu``.

So far: the whole zoo (ResNet-20/56, VGG-16, ResNet-50, AlexNet on
CIFAR-10 and ImageNet -- synthetic, or JPEGs decoded by a worker pool --
and the PTB LSTM and AN4 DeepSpeech model), every mode of the JAX
optimizer with its options and wire codecs, the eight top-k methods
(``auto | exact | blockwise | approx | threshold | pallas | twostage |
simrecall``), on one card or on P ranks over ``torch.distributed``
(spawned, or launched from outside with ``--multihost``); the trainer's
lifecycle (metrics, checkpoints, ``--resume``) and its resilience
(``exit_codes.py``, ``resilience/``: preemption, fault injection,
elastic resize); the three TPU top-k kernels as hand-written CUDA
(``ops/csrc``). Entry points: ``trainer.Trainer``,
``python -m gtopkssgd_tpu_torch.dist_trainer``.
"""
