"""gTop-k S-SGD in PyTorch and CUDA, for NVIDIA Hopper (H100).

The port of ``gtopkssgd_tpu`` (JAX on a TPU), which stays beside it as the
reference. It imports torch, numpy and the standard library only -- never
jax, never ``gtopkssgd_tpu``.

So far: ResNet-20/56 on CIFAR-10, every flat mode (``dense``, ``gtopk``
and the Top-k allgather baseline ``allgather | topk | topkA |
topk_allgather``) with the flat path's options (clip before compress,
dense warm-up, DGC momentum correction, Nesterov, the lr ramp, the
``fp32 | int8 | fp8`` wire codecs of ``parallel/codec.py``), top-k
methods ``exact | threshold | pallas | twostage``, on one worker or on P
ranks over ``torch.distributed`` (the gTop-k hypercube and the allgather
in ``parallel/collectives.py``); the three TPU top-k kernels as
hand-written CUDA (``ops/csrc``). Entry points: ``trainer.Trainer``,
``python -m gtopkssgd_tpu_torch.dist_trainer``.
"""
