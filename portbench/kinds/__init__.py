"""Model kinds, one module a kind, found by the configuration's
``arch["kind"]`` (``spec.kind``), as a metric's reader is found by its
name: a new kind of model is a new file here. A kind module gives:

* ``pool(config, seed, rank, count, batch)``: `count` host batches of
  `batch` samples, each a dict of numpy arrays under the keys that the
  port's dataset yields for the configuration's ``dnn``; a pure function
  of (seed, rank);
* ``init(config, seed)``: the reference's parameters by path
  (``reference.models.Params``), in float32 from the seed;
* ``loss(config, params, batch, quant, gen)``: the reference's forward
  pass and the model's loss on one batch, its arrays as tensors on the
  device; `quant` is applied to the operands of every matrix product
  (``reference/lowp.py``), `gen` draws dropout masks (None: no dropout);
* ``forward_macs(config)``: multiply-adds of one sample's forward pass,
  counted from the configuration's shapes (``yardstick.step_flops``);
* optionally ``flat_perm(path, dims)``: the permutation that lays the
  leaf at `path` out in the flat gradient; without one,
  ``reference.models.flat_perm``'s rule holds.

A kind is plain PyTorch and NumPy: it imports nothing of the program.
Modules whose names begin with ``_`` hold what kinds share.
"""
