"""Operation and byte counts computed from shapes, and the chip's peaks.

These are the benchmark's yardstick: the program is never asked what it
did.  Counts follow the work the function needs (each input byte read
once, each output byte written once), whatever route implements it.

A model family's counts are ``costs/<name>.py``, found by the name a
configuration file gives under ``"reference"`` (its reference is
``reference/<name>.py``).  Such a module gives ``prefill_flops(model, b,
s)`` and ``train_flops(model, b, s)``: the model FLOPs of a prefill and of
a train step of ``b`` rows of ``s`` tokens."""
from __future__ import annotations

from perfbench import reference


def of(conf: dict):
    """The cost module of the family the configuration `conf` names."""
    return reference.of(conf, __name__)
