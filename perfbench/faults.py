"""Faults planted under the timed path, to show that the comparison sees
them (the tests, at small sizes) and to read them on the chip at the
cells' own sizes (``calibrate.py --fault``), where a training cell's
faults set upper readings of its limits.  Each kind's faults take what the
kind's ``fault`` hook is given: a prefill's logits (or, for a fault whose
``stage`` is ``"route"``, the program's routing function, which it
wraps), a train step's job and batch, a sweep's engine."""
from __future__ import annotations

import torch
import torch.nn.functional as F


# ------------------------------------------------------------- prefill
def answer_altered(logits: torch.Tensor) -> torch.Tensor:
    """One position's logits of every answer altered where produced."""
    out = logits.clone()
    out[:, 0] = out[:, 0].roll(1, dims=-1)
    return out


def answer_shifted(logits: torch.Tensor) -> torch.Tensor:
    """Every answer's logits delivered one position late."""
    return logits.roll(1, dims=1)


def answer_tail_altered(logits: torch.Tensor) -> torch.Tensor:
    """The last eighth of every answer's positions altered where
    produced (the later query tiles, the tokens that overflow capacity)."""
    out = logits.clone()
    tail = max(1, logits.shape[1] // 8)
    out[:, -tail:] = out[:, -tail:].roll(1, dims=-1)
    return out


def route_altered(route):
    """Where the routing is produced, every token's k-th expert swapped
    for its (k+1)-th, with the slots and drops that follow from it."""
    def altered(p, x, **kw):
        r = route(p, x, **kw)
        probs, idx = r["probs"], r["gate_idx"]
        k = idx.shape[-1]
        nxt = torch.topk(probs, k + 1, dim=-1).indices[..., k:]
        idx = torch.cat([idx[..., :k - 1], nxt], dim=-1)
        vals = probs.gather(-1, idx)
        flat = idx.reshape(idx.shape[0], -1)
        slots = torch.cumsum(F.one_hot(flat, p.w_up.shape[0]), dim=1) - 1
        pos = torch.gather(slots, 2, flat[..., None])[..., 0]
        return dict(r, gate_idx=idx, flat_expert=flat, pos=pos,
                    keep=pos < r["cap"],
                    gate_vals=vals / vals.sum(-1, keepdim=True))
    return altered


route_altered.stage = "route"


# ------------------------------------------------------------- train
def state_unchanged(job, batch):
    """A step that computes its loss and returns its state unchanged."""
    return {"loss": job.model.loss(batch).detach()}


def half_batch(job, batch):
    """Half of the batch's tokens left out, the mean taken over the rest
    (a batch of one row loses the second half of its positions)."""
    labels = batch["labels"].clone()
    b, s = labels.shape
    if b > 1:
        labels[b // 2:] = -1
    else:
        labels[:, s // 2:] = -1
    job.state, m = job.train_step(job.state, dict(batch, labels=labels))
    return m


def token_altered(job, batch):
    """One token of the batch altered where it is produced."""
    toks = batch["tokens"].clone()
    toks[0, 0] = (toks[0, 0] + 1) % job.conf["model"]["vocab"]
    job.state, m = job.train_step(job.state, dict(batch, tokens=toks))
    return m


# ------------------------------------------------------------- sweep
def sweep_state_unchanged(engine):
    """Each chunk step returns the carry it was given."""
    step = engine._step

    def unchanged(carry, start, stop, filt):
        _, survivor, ys, ids = step(carry, start, stop, filt)
        return carry, survivor & False, ys, ids
    engine._step = unchanged


def sweep_half_chunk(engine):
    """Half of each chunk's designs left out."""
    ev = engine._chunk_eval

    def half(idx):
        ys, dom = ev(idx)
        ys = ys.clone()
        ys[ys.shape[0] // 2:] = float("inf")
        return ys, dom
    engine._chunk_eval = half


def sweep_answer_altered(engine):
    """One design's objectives altered where they are produced."""
    ev = engine._chunk_eval

    def altered(idx):
        ys, dom = ev(idx)
        ys = ys.clone()
        ys[1000] *= 0.5
        return ys, dom
    engine._chunk_eval = altered


BY_NAME = {f.__name__: f for f in (
    answer_altered, answer_shifted, answer_tail_altered, route_altered,
    state_unchanged, half_batch,
    token_altered, sweep_state_unchanged, sweep_half_chunk,
    sweep_answer_altered)}
