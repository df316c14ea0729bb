"""The benchmark of the PyTorch and CUDA port (``gtopkssgd_tpu_torch``).

``python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` trains one cell of ``BENCHMARK.json`` through the port's
``Trainer.train`` and prints one JSON result line. The harness is driven
by data: a cell names a model configuration (``configs/<name>.json``),
whose kind of model is a module of its own (``kinds/<kind>.py``: batches,
reference, loss, FLOPs), and a traffic mix (``traffic/<name>.json``),
keeps its correctness limits in ``workloads/<cell>.json``, and each
per-layer metric is a reader of its own (``metrics/<name>.py``), which
may name the program's ranges it reads. Nothing here imports JAX or the
JAX package.
"""
