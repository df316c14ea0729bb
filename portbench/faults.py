"""Faults planted under the timed path, to show that ``correct`` comes
out false when the program goes wrong (the readings' and the tests'
use; a benchmark run plants none).

* ``frozen``: the optimizer step returns, leaving the parameters, the
  residual and the velocity as they were;
* ``half_batch``: the loss is the mean over the first half of each
  batch, the rest left out;
* ``no_exchange``: the gradient exchange between ranks is left out;
  each rank applies its own local set as if it were the global one.
"""

from __future__ import annotations

FAULTS = ("frozen", "half_batch", "no_exchange")


def plant(fault: str, trainer):
    """Break `trainer` (one rank's ``Trainer``) by `fault`; returns the
    function that mends what outlives the trainer."""
    if fault == "frozen":
        trainer.optimizer.step = lambda closure=None: None
    elif fault == "half_batch":
        forward = trainer._forward

        def half(batch):
            return forward({key: v[:v.shape[0] // 2]
                            for key, v in batch.items()})

        trainer._forward = half
    elif fault == "no_exchange":
        import gtopkssgd_tpu_torch.optimizer as opt_mod

        def local(mode, vals, idx, **_):
            return vals, idx, True

        exchange = opt_mod.sparse_allreduce
        opt_mod.sparse_allreduce = local

        def mend():
            opt_mod.sparse_allreduce = exchange

        return mend
    else:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
    return lambda: None
