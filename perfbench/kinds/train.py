"""Training traffic: one training job taking ``batch`` x ``seq`` token
rows drawn uniformly over the vocabulary (every row differs), labels the
next token, each step the program's train step (loss, backward, AdamW).

Set-up builds one train step with its model and optimizer state and drives
it through its first ``setup_steps`` steps with the window's own call and
feed; the window then goes on with the same object.  The plain reference
the configuration names follows those first steps from the same weights and
batches, and then takes the loss of the window's first batch.  The numbers
compared are each of those steps' loss (its relative gap), the window's
first step's included, the first gradient as the optimizer got it (worked
out from the first moment after one step), and the parameters' change over
the set-up steps, both by the worst leaf: the gap between the program's
norm of the leaf and the reference's, over the larger of the reference's
norm of that leaf and of the median leaf.  A leaf whose reference gradient
is under a thousandth of the median leaf's (moved by round-off alone, as
the key bias under the softmax) is left out of the change."""
from __future__ import annotations

from typing import Dict

import torch

from perfbench import program, reference
from perfbench.weights import generator, make_weights

SMALL_GRAD = 1e-3      # of the median leaf's gradient norm: round-off only


def leaf_gap(got: Dict[str, float], ref: Dict[str, float],
             names=None) -> float:
    """max over leaves of |got - ref| / max(ref_leaf, median leaf of ref)."""
    names = list(ref) if names is None else list(names)
    vals = sorted(ref[n] for n in ref)
    med = vals[len(vals) // 2]
    return max(abs(got[n] - ref[n]) / max(ref[n], med, 1e-30)
               for n in names)


def norms(tensors: Dict[str, torch.Tensor], scale: float = 1.0
          ) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.double())) * scale
            for n, t in tensors.items()}


class Job:
    def __init__(self, conf: dict, mix: dict, seed: int, device,
                 fault=None):
        self.conf, self.mix, self.seed, self.dev = conf, mix, seed, device
        self.fault = fault
        self.ref = reference.of(conf)
        self.failed = 0
        self.read: Dict[str, object] = {}

    def batch(self, gen: torch.Generator):
        b, s = self.mix["batch"], self.mix["seq"]
        rows = torch.randint(0, self.conf["model"]["vocab"], (b, s + 1),
                             generator=gen, device=self.dev)
        return rows[:, :-1].contiguous(), rows[:, 1:].contiguous()

    def _weights(self):
        return make_weights(self.conf, self.seed, self.dev)

    def setup(self) -> None:
        from repro_torch.launch.steps import make_train_step
        from repro_torch.optim import AdamWConfig, adamw_init
        self.model = program.build(self.conf, self._weights(), self.dev)
        self.opt_cfg = AdamWConfig(**self.conf["optimizer"])
        self.train_step = make_train_step(self.model, self.opt_cfg)
        params = dict(self.model.named_parameters())
        self.state = adamw_init(params)
        self.gen = generator(self.seed, "batches", self.dev)
        losses = []
        for i in range(self.mix["setup_steps"]):
            metrics = self._step()
            losses.append(float(metrics["loss"]))
            if i == 0:
                self.read["grad"] = norms(self.state["m"],
                                          1.0 / (1.0 - self.opt_cfg.b1))
        p0 = self._weights()
        self.read["change"] = {n: float(torch.linalg.vector_norm(
            (p.detach() - p0[n]).double())) for n, p in params.items()}
        del p0
        self.read["loss"] = losses

    def _step(self) -> dict:
        toks, labels = self.batch(self.gen)
        batch = {"tokens": toks, "labels": labels}
        if self.fault is not None:
            return self.fault(self, batch)
        self.state, metrics = self.train_step(self.state, batch)
        return metrics

    def step(self, i: int) -> float:
        metrics = self._step()
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        if i == 0:
            self.read["loss"].append(float(metrics["loss"]))
        return float(self.mix["batch"] * self.mix["seq"])

    def close_window(self) -> None:
        del self.model, self.train_step, self.state
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, mode: str = "fp32") -> dict:
        """The reference's first set-up steps from the seed's weights and
        batches, then the loss of the window's first batch: {"loss": [...],
        "grad": leaf norms of the first clipped gradient, "change": leaf
        norms of the parameters' change over the set-up steps}."""
        gen = generator(self.seed, "batches", self.dev)
        batches = [self.batch(gen) for _ in range(self.mix["setup_steps"])]
        window = self.batch(gen)
        w = self._weights()
        o = dict(self.conf["optimizer"])
        with self.ref.precision(mode):
            out = self.ref.train_steps(w, batches, self.conf["model"], o)
            with torch.no_grad():
                out["loss"].append(float(self.ref.loss(w, *window,
                                                       self.conf["model"])))
        p0 = self._weights()
        change = {n: float(torch.linalg.vector_norm((w[n] - p0[n]).double()))
                  for n in w}
        return {"loss": out["loss"], "grad": out["leaf_grad"][0],
                "change": change}

    def numbers(self, got: dict, ref: dict) -> Dict[str, float]:
        grads = ref["grad"]
        med = sorted(grads.values())[len(grads) // 2]
        moved = [n for n in grads if grads[n] >= SMALL_GRAD * med]
        return {
            "loss_gap": max(abs(a - b) / abs(b)
                            for a, b in zip(got["loss"], ref["loss"])),
            "grad_gap": leaf_gap(got["grad"], grads),
            "change_gap": leaf_gap(got["change"], ref["change"], moved),
            "leaves_left_out": float(len(grads) - len(moved)),
        }

    def compare(self) -> Dict[str, float]:
        return self.compare_with_control(False)["program"]

    def compare_with_control(self, control: bool) -> dict:
        """The program's numbers against the reference, and with `control`
        those of the control (the reference in TF32) against it."""
        ref = self.reference()
        return {"program": self.numbers(self.read, ref),
                "control": (self.numbers(self.reference("tf32"), ref)
                            if control else None)}

    def end_to_end(self, win: dict) -> Dict[str, float]:
        return {"train_tokens_per_s": win["work"] / win["window_s"]}
