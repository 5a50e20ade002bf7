"""Plain references of what the benchmark runs, one module a family.

A configuration file names its family's reference (``"reference":
"<name>"``) and the harness takes ``perfbench/reference/<name>.py`` by
that name, as it takes ``perfbench/costs/<name>.py`` for the family's
FLOP counts.  A model's reference module gives:

- ``PUBLISHED``: published key -> the configuration's ``model`` field;
  every key in it is compared with the configuration's ``published``
  block (the tests: a key in ``reduced`` may only be smaller), and may
  give ``PUBLISHED_WHEN``: model field -> a further such mapping, every
  key of which is compared where the model sets that field (an MoE
  model's expert widths);
- ``param_spec(model)``: (name, shape) of every weight, in a fixed order;
- ``init_leaf(name, t)``: scale the unit normal leaf ``t`` in place to its
  role;
- ``precision(mode)``: a context in which products run in ``"fp32"`` or,
  for the control, ``"tf32"``;
- ``logits(w, tokens, model, routes=None)``: a prefill's logits;
  ``routes`` is the routing an MoE model follows and fills (``None`` for
  a model without experts);
- ``loss(w, tokens, labels, model)``: the mean next-token loss;
- ``train_steps(w, batches, model, opt)``: the optimizer's steps, with
  each step's loss and first leaf gradient norms.

Every reference imports torch alone: nothing of the program."""
from __future__ import annotations

import importlib


def of(conf: dict, package: str = __name__):
    """The module of `package` (this one, or ``perfbench.costs``) that
    the configuration `conf` names."""
    return importlib.import_module(f"{package}.{conf['reference']}")
