"""Prefill traffic: a closed loop of clients, each sending a prompt of
``batch`` x ``seq`` token ids drawn uniformly over the vocabulary, the
next one once the program's logits for the last are complete.

The answers checked are a sample of the window's requests (reservoir
sampling from the seed; ``sample`` of them, their logits kept as the
program returned them).  After the window the plain reference the
configuration names computes each sampled prompt's logits again.  Per
position, the gap is the largest over the vocabulary between the program's
logit and the reference's, in units of the reference logits' standard
deviation; the numbers compared are its median and its maximum over every
position.

In a model with experts, a token whose k-th and (k+1)-th router
probabilities lie within rounding may be routed either way by a sound
fp32 program, and every later position attends to it.  So the reference
follows the experts the program's routing chose (``route`` of
``repro_torch.models.moe``, wrapped from outside for the run: a reference
to each layer's choice is kept, with no copy and no sync) and does the
rest itself: the probabilities, the capacity and the drops, the experts,
attention.  The routing that this skips is checked by itself: at every
(token, layer) where the program's experts differ from those the
reference would choose there, the reference's margin between its k-th and
(k+1)-th probability (relative to the k-th) is read, and the number
compared is the largest (0 where none differ): a sound program parts
from the reference only at near-ties."""
from __future__ import annotations

import random
from typing import Dict, List, Optional

import torch

from perfbench import program, reference
from perfbench.weights import generator, make_weights, stream_seed


def gaps(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per position of (B, S, V) logits, (B, S): max over the vocabulary
    of |got - ref|, over the reference logits' standard deviation."""
    scale = ref.float().std()
    return (got.float() - ref.float()).abs().amax(dim=-1) / scale


def flip_margins(chosen: List[torch.Tensor], routes: dict) -> torch.Tensor:
    """The reference's margins at the (token, layer) decisions where the
    experts `chosen` ((B, S, k) a layer) differ from those the reference
    would choose (``routes["own"]``); empty where none differ."""
    out = [m[(c.sort(-1).values != o.sort(-1).values).any(-1)]
           for c, o, m in zip(chosen, routes["own"], routes["margins"])]
    return torch.cat([m.double().cpu() for m in out]) if out \
        else torch.zeros(0, dtype=torch.float64)


def summarize(per_pos: List[torch.Tensor], flips: List[torch.Tensor]
              ) -> Dict[str, float]:
    """The numbers compared: the median and the largest gap over every
    position, and the largest margin at which the routing parted from
    the reference's; beside them how many decisions parted."""
    every = torch.cat([g.reshape(-1).double().cpu() for g in per_pos])
    flip = torch.cat(flips) if flips else torch.zeros(0, dtype=torch.float64)
    return {"logit_gap_median": float(every.median()),
            "logit_gap_max": float(every.max()),
            "route_flip_margin": float(flip.max()) if flip.numel() else 0.0,
            "route_flips": float(flip.numel())}


class Job:
    def __init__(self, conf: dict, mix: dict, seed: int, device,
                 fault=None):
        self.conf, self.mix, self.seed, self.dev = conf, mix, seed, device
        self.fault = fault
        self.ref = reference.of(conf)
        self.shape = (mix["batch"], mix["seq"])
        self.failed = 0
        self.kept: List[tuple] = []
        self._pick = random.Random(stream_seed(seed, "sample"))
        self._taken: List[torch.Tensor] = []
        self._untap = None

    def _prompt(self, gen: torch.Generator) -> torch.Tensor:
        return torch.randint(0, self.conf["model"]["vocab"], self.shape,
                             generator=gen, device=self.dev)

    def _tap_routes(self) -> None:
        """Wrap the program's routing so that each call's chosen experts
        are kept for the request under way (a route fault goes under)."""
        from repro_torch.models import moe
        orig = moe.route
        inner = orig
        if getattr(self.fault, "stage", None) == "route":
            inner = self.fault(orig)
        taken = self._taken

        def tapped(*args, **kw):
            r = inner(*args, **kw)
            taken.append(r["gate_idx"])
            return r
        moe.route = tapped
        self._untap = lambda: setattr(moe, "route", orig)

    def setup(self) -> None:
        from repro_torch.launch.steps import make_prefill_step
        weights = make_weights(self.conf, self.seed, self.dev)
        self.model = program.build(self.conf, weights, self.dev)
        self.prefill = make_prefill_step(self.model)
        if self.conf["model"].get("n_experts"):
            self._tap_routes()
        warm = generator(self.seed, "warmup", self.dev)
        for _ in range(self.mix["warmup"]):
            self.prefill({"tokens": self._prompt(warm)})
        self.gen = generator(self.seed, "prompts", self.dev)

    def step(self, i: int) -> float:
        toks = self._prompt(self.gen)
        self._taken.clear()
        logits = self.prefill({"tokens": toks})
        if self.fault is not None and not hasattr(self.fault, "stage"):
            logits = self.fault(logits)
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        answer = (toks, logits, list(self._taken))
        if i < self.mix["sample"]:
            self.kept.append(answer)
        else:
            slot = self._pick.randrange(i + 1)
            if slot < self.mix["sample"]:
                self.kept[slot] = answer
        return float(toks.numel())

    def close_window(self) -> None:
        if self._untap is not None:
            self._untap()
            self._untap = None
        del self.model, self.prefill
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, toks: torch.Tensor, weights, mode: str = "fp32",
                  follow: Optional[List[torch.Tensor]] = None):
        """(logits, routes) of the reference for toks; with `follow` its
        tokens go to those experts (one (B, S, k) tensor a layer)."""
        routes = ({"capacity": self.conf.get("moe_capacity", 1.25),
                   "own": [], "margins": [], "follow": follow}
                  if self.conf["model"].get("n_experts") else None)
        with self.ref.precision(mode):
            out = self.ref.logits(weights, toks, self.conf["model"], routes)
        return out, routes

    def _judge(self, toks, got, chosen, weights):
        """(per-position gaps, flip margins) of an answer `got` whose
        routing chose `chosen`, against the reference following it."""
        ref, routes = self.reference(toks, weights, follow=chosen)
        flips = (flip_margins(chosen, routes) if routes is not None
                 else torch.zeros(0, dtype=torch.float64))
        return gaps(got, ref), flips

    def compare(self) -> Dict[str, float]:
        return self.compare_with_control(False)["program"]

    def compare_with_control(self, control: bool) -> dict:
        """The numbers of the program's kept answers against the reference,
        and with `control` those of the control (the reference in TF32,
        its own routing followed alike) on the same prompts."""
        weights = make_weights(self.conf, self.seed, self.dev)
        b, s = self.shape
        prog, ctrl = ([], []), ([], [])
        for toks, got, taken in self.kept:
            chosen = [t.reshape(b, s, -1) for t in taken] or None
            for out, val in zip(prog, self._judge(toks, got, chosen,
                                                  weights)):
                out.append(val)
            if control:
                c, croutes = self.reference(toks, weights, "tf32")
                cchosen = croutes["own"] if croutes is not None else None
                for out, val in zip(ctrl, self._judge(toks, c, cchosen,
                                                      weights)):
                    out.append(val)
                del c, croutes
        self.kept.clear()
        return {"program": summarize(*prog),
                "control": summarize(*ctrl) if control else None}

    def end_to_end(self, win: dict) -> Dict[str, float]:
        return {"prefill_tokens_per_s": win["work"] / win["window_s"]}
